"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--phases build,kernels,train_kernels,moe_kernels,sparse_kernels,e2e,
                                    train,remat,eager,zero,moe_zero,tp,moe_train,
                                    sparse_train,evo_kernels,evo_path,v1,hybrid,prefix_sample,
                                    families,families_train,offload,pipe_onebit]
    python3 chip_smoke.py --mutant [NAMES]
    python3 chip_smoke.py --ablation [NAMES]
    python3 chip_smoke.py --versus DIR [--phases kernels,e2e]
    python3 chip_smoke.py --versus DIR --phases moe_kernels,moe_train
    python3 chip_smoke.py --versus DIR --phases evo_kernels,evo_path
    python3 chip_smoke.py --versus DIR --phases sparse_kernels,sparse_train
    python3 chip_smoke.py --versus DIR --phases train
    python3 chip_smoke.py --versus DIR --phases train_kernels

With no arguments every phase runs, in this order; each must pass (exit
code 1 otherwise):

1. build: compile the six hand-written CUDA sources of
   ``deepspeed_tpu_torch/ops/csrc`` with nvcc for sm_90a, one nvcc per
   source, all started together, and beside them the two host C++ ops
   (``csrc/adam/cpu_adam.cpp``, ``csrc/aio/deepspeed_aio.cpp``) with g++;
   print each nvcc's wall time and the ``-Xptxas -v`` registers / shared
   memory / spills per kernel.
2. kernels: print the paged kernels' ptxas registers and spills (any spill
   fails) and the decode's and prefill's shared memory per CTA at every
   head dim; hold every paged-attention path (``paged_decode`` with
   kv_splits 1 and 8, ``paged_prefill``) against the plain PyTorch
   version on the card, bf16 and int8 pools, GQA 32/8, head_dim 128, block
   64, plus window / ALiBi / head_dim 64 cases at small sizes, and the
   model families' shapes there: g 1 at head_dim 64, 80, 96, 128 and 256,
   g 7 at 128 (a prefill tile of 9 tokens), g 16 at 64 and g 71 over one kv
   head at 64 (nine decode head tiles; prefill tiles of 8 tokens in nine
   64-row chunks), plain and with ALiBi slopes, int8 pools too at 80 and
   256. Tolerance,
   per output element: |kernel - plain| <= 2 ulp(plain) + 2^-14, with ulp
   the spacing of bfloat16 numbers at |plain|. Both sum in fp32 (the
   kernels on the tensor cores, whose products take the 16-bit inputs
   exactly and the probabilities as a split hi + lo pair, ~2^-17 relative;
   the plain version in fp32 einsums) and round once to bf16 at the end,
   so their fp32 results differ by about 1e-6 of the terms' size. Values
   that close round to bf16 numbers at most one ulp apart (two where a
   power of two lies between them); the 2^-14 floor covers that difference
   where an output is near zero and its ulp is smaller. The split decode's
   two kernels are also checked apart: its fp32 partials (``acc``, ``m``,
   ``l`` per split of each token's live blocks) against
   ``paged_decode_partials_reference``, within 2^-14 (1 + |m|) for m,
   2^-14 l for l and 2^-14 l max|v| for each element of acc (the split P
   and the scores' fp32 rounding move a term by ~2^-17 of itself, and acc
   is a sum of at most l max|v|), and the merge kernel on those partials
   against ``merge_decode_splits`` with the bf16 rule. The prefill runs at
   its default tile (64 / g tokens). At the main path's shapes (decode of
   32 sequences x 1024 context, a 512-token prefill chunk) time the kernel
   (CUDA events over many warmed launches; also each path's device time
   with the host queued ahead behind a device-side wait, and for the
   prefill the time of the tile descriptors that a forward's first layer
   computes; the split route's split kernel and merge kernel alone),
   the plain version, and ``F.scaled_dot_product_attention`` on the same
   context pre-gathered contiguous (a yardstick only: it excludes the
   gather; the prefill's is also run through the contiguous flash forward),
   beside the least time the card could take (bytes / 3.35 TB/s
   or FLOPs / 989 TFLOP/s, whichever is larger). The largest error as a
   fraction of its tolerance is printed as ``worst_error_fraction``. Then
   the six presets at head dims 80 / 96 / 256 or group sizes over 8 (phi-2,
   GPT-NeoX-20B, GPT-J-6B, Pythia-1B, Falcon-40B, Falcon-7B) at their head
   shapes and the same sizes, bf16 pools: each route checked once against
   the plain version and timed (events, and with the host queued ahead)
   beside its byte bound and SDPA on the same context pre-gathered.
3. train_kernels: print the flash kernels' ptxas registers and spills (30
   instantiations: 3 kernels x head dims 64 / 80 / 96 / 128 / 256 x bf16 /
   fp16; any spilled byte fails) and their shared memory per CTA, then hold
   the training kernels against their plain versions.
   Flash attention (``flash_fwd``, ``flash_bwd_dkdv``, ``flash_bwd_dq``) on
   a small matrix (S 1 / 100 / 128 / 257, head_dim 64 / 80 / 96 / 128 /
   256, GQA groups 1 and 4, causal and not, window 48, ALiBi with
   power-of-two and other head counts, bf16, and float16 at every head dim)
   and at the training shapes (B 1, S 4096, 32/8 heads, d 128,
   bf16, causal, window 4096): out, lse, dq, dk, dv. Then at the presets'
   attention shapes (``FLASH_FAMILY_SHAPES``: phi-2 32/32 d 80,
   GPT-NeoX-20B 64/64 d 96, GPT-J-6B 16/16 d 256, Pythia-1B 8/8 d 256,
   Falcon-7B 71/1 d 64; B 1, S 2048, causal) each kernel is checked the same
   way and timed beside its bound and SDPA (the plain version not timed). The backward kernels
   and their plain version take the same inputs (the kernel forward's out
   and lse); the kernels run in the autograd Function's order, dq first,
   whose delta = rowsum(dO * O) dk/dv then reads. Tolerance per element:
   bf16 outputs 2 ulp(plain) + max(2^-14, 2^-12 * rms(plain)), the floor
   scaled to the tensor's size because a gradient element is a long sum
   (up to 4 x 4096 terms) that may cancel to far below its terms, where
   the fp32 summation order alone moves it
   by ~1e-6 of the terms (2^-12 leaves a wide margin); lse (fp32, never
   rounded) 2^-14 * (1 + |plain|). Fused AdamW (``fused_adam``) on 2.58e8
   fp32 elements over leaves of odd sizes (one at an unaligned address),
   gate 1 within 1e-6 * |plain| (both do the same IEEE-rounded fp32
   operations in the same order, so they should agree exactly) and gate 0
   bit-identical to the input. Times (CUDA events) against the bound, the
   plain version and a library call: ``F.scaled_dot_product_attention``
   forward, and its autograd backward for the two backward kernels
   together; ``torch.optim.AdamW(fused=True)`` on the same tensors.
4. moe_kernels: count the ``HGMMA`` instructions in the grouped matmul
   library's SASS (``cuobjdump -sass``; none, or no cuobjdump, fails) and
   print the wgmma kernels' ptxas registers, spills and shared memory; hold
   the grouped matmul kernels (``gmm``, with and without ``trans_b``, and
   ``tgmm``) against their plain versions on small cases
   (bf16 and fp16, K and N off the tiles and off multiples of 8, an expert
   owning only a zero padding block, a single expert, 256-row blocks, the
   main path's widths) and at the main path's shapes (Mixtral-8x7B's expert
   FFN over 4096 tokens routed top-2 by the port's dispatcher: 8192 rows,
   T_pad 9216, K / N 4096 / 14336 and back). Tolerance: gmm as flash (2
   ulp(plain) + max(2^-14, 2^-12 rms(plain))); tgmm, fp32 and never
   rounded, within 2^-16 sqrt(rows summed into out[e]) rms(plain[e]) per
   expert: the fp32 summation order moves a sum of n terms by ~2^-24
   sqrt(n) of its size, and one lost 128-row block moves it by
   sqrt(128 / n) of its size, far above. Times against the bound (counted
   over the routed rows), the plain version and a library yardstick
   (``torch._grouped_mm`` where it takes the layout, else a loop of E
   ``torch.mm``). Each case prints its route (``route(K, N)``: the wgmma
   kernels for widths that are multiples of 8, else the wmma ones), and the
   Mixtral widths must launch only the wgmma kernels; tgmm's dw cast to
   bf16 is timed beside it. Then the serving modules at Mixtral width,
   ``grouped_gemm_moe`` against ``top_k_gated_moe`` (relative L2 1e-2) on
   a 512-token chunk and an 8-token decode batch.
5. sparse_kernels: print the tensor-core kernel's ptxas registers and
   spills (d 64 and 128 must not spill) and both kernels' shared memory;
   hold ``block_sparse_fwd`` against the plain gathered version on the same
   inputs (q, k, v read through the model's [B, S, n, d] strides) on both
   routes: bf16 / fp16 take the tensor-core kernel, fp32 the CUDA-core one
   (``route(dtype)``), and every case runs in its dtype and in the other
   route's (fp32 for a 16-bit case, bf16 for an fp32 one), each launch
   expected on its route: small cases over block 16 / 32 / 64 / 128,
   head_dim 32 / 64 / 128, bf16 / fp16 / fp32, causal and not, rpe,
   key-padding and attn masks in 'add' and 'mul' modes, per-head layouts,
   empty rows (zeros) and a fully padded sample (zeros); then the main
   path's shape (B 1, 32 heads, L 4096, d 128, the slice's 'fixed' layout,
   causal) in bf16 and the same values in fp32. The flash tolerance: both
   sides sum in fp32 and round once. Times of both routes (CUDA events)
   against the bound (bytes of q, k, v and out, or 4 d FLOPs per visible
   (q, k) pair of this layout; fp32 at the CUDA cores' 67 TFLOP/s), the
   plain version and ``F.scaled_dot_product_attention`` with the layout
   and causality as a boolean mask; the backward's time and transient peak
   (the gathered recompute). The largest error as a fraction of its
   tolerance is printed as ``worst_error_fraction``.
6. e2e: Mistral-7B at full width and depth (32 layers), random weights from
   a seeded generator, served through ``DynamicSplitFuseScheduler`` over
   ``InferenceEngineV2``: requests chosen so that every kernel path runs,
   with launch counts reset just before and read just after; then one
   prefill's last-token logits through the kernels against the same
   forward through ``dense_blocked_attention`` (relative L2 error); then
   profiles of a decode horizon and of one 512-token ``put`` (device time
   by kernel, device idle share of the host's wall clock), and that put's
   wall with the prefill's tile descriptors computed in every layer (the
   wrapper's memo bypassed by this script). The decode profile also counts
   the device kernels (and copies) per step.
7. train: the serving engine is freed first. Mistral-7B at full width with
   its depth cut 32 -> 8 for memory, fp32 masters from a seeded generator,
   trained through ``deepspeed_tpu_torch.initialize`` -> ``train_batch``
   (bf16 compute, AdamW through the fused kernel, clipping 1.0, WarmupLR,
   2 microbatches of 1 x 4096 tokens): one warm step, then 4 timed steps
   with the training kernels' launch counts reset just before and read just
   after; losses finite and falling, step time, tokens/s, peak memory, a
   profiled step (device busy vs wall, top device ops), the fused AdamW
   timed at the full parameter set; then one forward and backward at seq
   1024 through the kernels against the same through the plain attention
   on the same weights (loss and whole-gradient relative L2 error).
8. remat: activation checkpointing on the train phase's configuration
   (Mistral-7B width, 8 layers, one model and its weights): one
   microbatch's loss and gradients with ``remat`` off, then with each of
   ``nothing_saveable``, ``dots_saveable`` and
   ``save_only_these_names(attn_out)``, each held against remat off (the
   loss equal, the gradients' relative L2 within 1e-5) with its flash
   launches held to the design (the forward twice a layer under every
   policy: the recompute runs the kernel again, and ``attn_out`` keeps the
   context but not the backward's lse); then under each setting a warm
   ``train_batch`` and 3 timed ones: step time, peak memory, launches a
   step; the peak under ``nothing_saveable`` must be below remat off's.
   Then Mixtral-8x7B's widths at depth 2 on the grouped path, top-2 with the
   Gumbel second expert drawn from the row's generator: one microbatch's
   loss and gradients with ``remat`` against without (1e-5; gmm / tgmm and
   flash launched, gmm and the flash forward again in the recompute).
   Last, ``checkpointing.configure(checkpoint_in_cpu=True)`` on a [4096,
   4096] fp32 region: its input must leave the device until the recompute
   and the value and gradients equal the region's kept on the device.
   ``worst_error_fraction`` is printed.
9. eager: the train phase's configuration built twice from seed 0, one
   engine at a time: 2 steps of ``forward`` / ``backward`` / ``step`` at gas
   2 against 2 ``train_batch`` steps on the same ids: the losses equal, the
   parameters after the second step within relative L2 1e-6 (0 expected),
   the launches equal.
10. zero: ZeRO stages 0, 1, 2 and 3 at data-parallel world size >= 2, one
   process a rank (this script with ``--zero-rank``, the environment
   torchrun's), loading the kernels the build phase built: with two or more
   visible cards min(4, count) ranks over NCCL, one a card, at Mistral-7B's
   width with the depth cut 32 -> 8; with one card two ranks sharing it over
   gloo (NCCL takes one rank a device; gloo copies each collective through
   the host), depth cut 32 -> 2. bf16, fused AdamW, clipping 1.0, gas 2,
   1 x 2048 tokens a rank a microbatch (ids from 256 tokens), a constant lr
   1e-3; every stage 3 steps from seed 0 in one process group, through
   ``initialize`` -> ``train_batch``; first, in this process, stage 0 at
   world size 1 on the same global batch (micro = the world size). The
   losses and gradient norms of stages 1-3 must match stage 0's within
   2e-4, stage 0's must match world size 1's within 2e-3, every rank's
   parameters after the steps must equal rank 0's (each broadcast from
   rank 0; the largest relative L2 difference, or of the other checks, as
   a fraction of 2e-4 or its tolerance is ``worst_error_fraction``),
   stage 0's losses fall, each
   rank's peak memory must fall with each stage, and on every rank and
   stage the flash kernels must launch once a layer a microbatch and the
   fused AdamW once a step (on the rank's shards at stages >= 1). Each
   rank's losses, step times, peak and resident bytes are printed. With four
   cards, also stage 3 at full depth (32 layers), each rank's peak printed.
   Each spawn also runs stage 3 with ``remat`` (``nothing_saveable``): its
   losses and gradient norms within 2e-4 of stage 3's, each rank's peak no
   higher, the partition's gathers a step equal (printed), the flash
   forward twice a layer a microbatch; at full depth its peak is printed
   beside stage 3's.
11. moe_zero: MoE training at data-parallel world size >= 2 with the
   experts over the ranks, spawned as ``zero`` spawns (``--zero-rank`` with
   impl:stage cases): Mixtral-8x7B's widths (8 experts, top-2 with the
   Gumbel second expert drawn from each row's generator, capacity factor
   1.25, rope_theta 1e6, no window) on the zero phase's training
   configuration. First, in this process, world size 1 on the same global
   batch, one row a microbatch in the ranks' order (every product then has
   the ranks' shapes), for both ``moe_impl``s. With one card, two gloo
   ranks sharing it at depth 1 (32 -> 1): the einsum path at stage 1 (its
   capacity slots exchanged with the experts' owners by all-to-all) and
   the grouped path at stage 3 (the experts gathered in bf16 where the
   forward reaches a block, their gradients reduce-scattered to the
   owners); with two or more cards min(4, count) NCCL ranks at depth 2,
   then, on four, depth 8 with the experts over the four cards at stages 0
   and 3 for both paths (no world size 1: it does not fit one card). Each
   rank must hold exactly its experts of the initial weights (``E /
   world`` of every block's); the losses and gradient norms must match
   world size 1 within 2e-3 and 1e-2 (1.5e-1 where the first layer's gate
   picks other experts for some token than world size 1's: bf16 routing
   ties; such tokens are counted); at depth 8 stage 3 must match stage 0
   within 2e-4 for each path; einsum must match grouped at the first step,
   on the same weights, within 2e-3 and 1e-2 (after an AdamW step the two
   paths part at world size 1 too; the later gap is printed); every
   non-expert group must equal rank 0's; gmm / tgmm (grouped), flash, the
   fused AdamW and the all-to-all (einsum) must launch on every rank as
   many times as the layers and microbatches say; and the first block's MoE
   FFN through the partition (this rank's experts; the slots exchanged, or
   the experts gathered) must match the same FFN on the whole fp32 experts
   on one input (identical routing; y, dh and this rank's experts'
   gradients, the whole gradients summed over the ranks) within relative
   L2 1e-2. Each rank's losses, step times, peak and resident bytes (the
   experts apart), the seconds of each case's set-up, steps and checks,
   and ``worst_error_fraction`` are printed.
12. tp: tensor parallelism (the ``model`` mesh axis), spawned as ``zero``
   spawns (``--zero-rank`` with ``tp:`` cases), Mistral-7B's width. Each
   rank builds its shards of the tree world rank 0 draws from seed 0 (each
   leaf broadcast and sliced as it is drawn: no rank holds the whole tree).
   First, in this process, world size 1 on each case's global batch (the
   zero phase's configuration with the train phase's AdamW at a constant
   lr 1e-4) and ``tp_size`` 1 serving
   (``init_inference``, full depth, the v1 waves), each freed after. With
   one card, two gloo ranks sharing it: ``model 2 x data 1`` at depth 2
   (32 -> 2), 16/4 heads a rank; with four cards four NCCL ranks: ``data 2
   x model 2`` at stages 1 and 3 and ``data 1 x model 4`` at depth 8, then
   stage 3 at full depth over ``data 2 x model 2`` with its peak per rank.
   Losses and gradient norms must match world size 1 within 2e-3 (stage 3
   against stage 1 within 2e-4), the replicated leaves must equal model rank 0's
   after every step, flash (on the rank's query and kv heads) and the
   fused AdamW must launch as the layers and microbatches say. Serving:
   ``init_inference(tensor_parallel={"tp_size": ranks})`` at full depth on
   the v1 waves (4 x 20 + 44, 8 x 960 + 64: the split decode and merge):
   each rank's prefill last-token logits within relative L2 5e-2 of
   ``tp_size`` 1's, its first-layer cache (its kv heads) within 1e-2, the
   tokens equal on every rank (those agreeing with ``tp_size`` 1 counted),
   the paged prefill, decode and merge launched; decode ms per step (wall,
   and device busy on the first wave) beside ``tp_size`` 1's. Peaks, step
   times and ``worst_error_fraction`` are printed.
13. moe_train: the earlier engines freed, Mixtral-8x7B's widths (8 experts,
   top-2, the grouped path, capacity factor 1.25, rope_theta 1e6, no
   window) with the depth cut 32 -> 2 for memory, trained as in ``train``
   (the engine's seeded generator drives the gating's draws): losses finite
   and falling, step time, tokens/s, peak memory, launches (exactly 24
   gmm, 12 tgmm, 4 of each flash kernel and 1 fused Adam per step), a
   profiled step; then at seq 1024 the grouped kernels against the plain
   grouped path, on the last layer's MoE FFN with one input (identical
   routing; relative L2 1e-2) and on the whole model (loss 2e-3, gradient
   1.5e-1: the last layer's gate sees inputs that differ in the last bf16
   bit, and the tokens it routes differently, printed, move whole tokens'
   contributions between experts).
14. sparse_train: the earlier engines freed, Llama-2-7B's widths with the
   depth cut 32 -> 8 and the ds_config's ``sparse_attention`` block (the
   documented 'fixed' layout, unidirectional), trained as in ``train``:
   losses finite and falling, step time, tokens/s, peak memory, launches
   (exactly 16 ``block_sparse_fwd`` per step on the tensor cores, none on
   ``block_sparse_fwd_fp32``, no flash, 1 fused Adam), a profiled step;
   then at seq 1024 the whole model through the kernel against the same
   through the plain forward (loss 2e-3, gradient 5e-2).

15. evo_kernels: hold the Evoformer kernels (``evo_fwd``, ``evo_bwd_dq``,
   ``evo_bwd_dkdv`` with the mask bias's ``db1`` summed inside it, and
   ``evo_bwd_db2``) against their plain versions on the same inputs (the
   backward on the kernel forward's out and lse): out, lse, dq, dk, dv,
   db1, db2 over 28 small cases (each bias present or absent, G 1 and 2,
   R 1 / 64 / 100 / 130 / 200 / 257, head_dim 32 / 64 / 128, bf16 / fp32 /
   fp16, five rows in one group (with ``evo_bias_two_rows``, a one-row tail),
   OpenFold's 1e9 mask with a fully masked row, whose output and
   lse are checked for finiteness only and whose dout is 0, as the model
   masks it; db2 with one row a group and with 32 rows in 11 chunks) and at
   the main shape (MSA row attention with the pair bias: N 512, R 384, 8
   heads, d 32), each on both routes: bf16 / fp16 take the tensor-core
   kernels, fp32 the CUDA-core ones (``route(dtype)``), and every case runs
   in its dtype and in the other route's (fp32 for a 16-bit case, bf16 for
   an fp32 one; the main shape in bf16 and fp32). The launches of each
   route are counted and printed, with the tensor-core kernels' ptxas
   registers and spills (the d 32 forward and dq must not spill). Tolerance per element: bf16 / fp16
   outputs the flash rule; fp32 outputs 2^-16 |plain| + 2^-14 rms(plain)
   (both sum in fp32 in another order and never round to a narrower type);
   lse 2^-14 (1 + |plain|); the fp32 bias sums (db1 over h x R terms, db2
   over the group's n_seq rows) as tgmm's, 2^-16 sqrt(terms) rms(plain);
   each gradient also gets 2^-18 of the same sum over its terms' absolute
   values, since where a gradient cancels to far below its terms (R 1:
   ds = dp - delta is rounding alone on both sides) only that scale says
   what summation order may move.
   Times (CUDA events) of both routes at the main shape against the bound
   (fp32: its bytes, and its FLOPs at the CUDA cores' 67 TFLOP/s), the
   plain version and a library yardstick: ``F.scaled_dot_product_attention``
   with bias1 + bias2 materialised as a float mask in q's dtype, forward,
   and its backward with the mask's gradient for the backward kernels
   together; db1's time is that of the dk/dv launch that sums it (with
   what the sum adds beside it). ``worst_error_fraction`` is printed.
16. evo_path: one Evoformer block's four attention calls (MSA row attention
   with the pair bias, MSA column attention, triangle attention around the
   starting and the ending node) at AlphaFold-2's fine-tuning crop (N_res
   384, N_clust 512) with OpenFold's heads (8 x 32 for the MSA, 4 x 32 for
   the pair), bf16 inputs, fp32 biases, OpenFold's 1e9 mask bias padding
   the last 10% of residues and four MSA rows; forward and backward through
   ``DS4Sci_EvoformerAttention``, with the module also loaded through
   ``get_accelerator().create_op_builder("EvoformerAttnBuilder")``: a warm
   block, then three timed blocks with the launch counts reset just before
   and read just after (4 fwd, 4 dq, 4 dk/dv with 4 db1 and 3 db2 per
   block, all on the tensor cores, none on the fp32 route),
   the median block time and peak memory, a profiled block; then
   the block through the plain versions: every output finite, and the
   output (off the fully masked rows) and all five cotangents of each call
   within relative L2 1e-2 of the plain path's.
17. v1: first the paged kernels in the v1 path's layout (a dense
   [B, Smax, 8, 128] cache viewed as a pool of 128-slot blocks with an
   identity block table, 32 / 8 heads) against the plain version with the
   ``kernels`` tolerance: the prefills and decodes of both waves and of
   the hybrid phase's rollout (4 x 64 + 32), each decode at one split and
   at the dispatcher's count (2 at Smax 1024), timed beside
   the bound. Then Mistral-7B at full width and depth (32 layers, bf16,
   random weights from seed 0) through ``init_inference``: with the launch
   counts reset just before and read just after, ``generate`` of 4 prompts
   x 20 tokens + 44 (Smax 128: the prefill kernel and the per-token
   decode), of 8 x 960 + 64 (Smax 1024: the prefill and the split decode
   with its merge) and one ``forward`` of [1, 2048] (the flash forward);
   each of the four paged routes and the flash forward must launch. Then
   each wave's prefill (a generate of one token) and decode ms per step,
   tokens/s, the device's idle share over the larger wave's decode steps
   (torch.profiler: the difference of two profiled generates, all tokens
   and one), peak memory; and each wave's last-token logits after its
   prefill and after one decode step, kernels against the dense route on
   the same weights (``attention_impl="reference"``), relative L2 within
   5e-2, the argmax agreement printed.
18. hybrid: the earlier engines freed, the ``train`` phase's configuration
   (Mistral-7B width, 8 layers, fp32 masters, bf16, fused AdamW; a
   constant lr) through ``initialize`` with ``hybrid_engine.enabled``:
   ``generate`` twice (4 x 64 + 32), ``train_batch`` x 2, ``generate``. The
   bf16 view must be written twice (at its build and after the step
   counter moved), a weight of it must change, the train mode must come
   back, the two rollouts on the same weights must agree, and the paged,
   flash and fused Adam kernels must each launch; the writes' and the
   generates' ms are printed. Then the rollout's last-token logits after a
   prefill and a decode step against the dense route on the same weights,
   relative L2 within 5e-2; and its generate timed in turns against an
   engine over the live fp32 masters (cast where used), each with its
   device busy time.
19. prefix_sample: Mistral-7B at full width and depth (bf16, random weights
   from seed 0, kv block 64, max_context 2048) with ``prefix_cache`` on and
   a 64-block host tier under it, served through ``DynamicSplitFuseScheduler``:
   8 requests share a 1,024-token system prompt (16 full blocks), each with
   a suffix of 64-200 tokens; request 5 leaves the prompt at token 1000
   (mid-block: a copy-on-write), request 7 repeats request 0's prompt; the
   even ones sample (temperature 0.8, top_p 0.95, seeds 1000 + uid), 32 new
   tokens each. Request 0 runs alone until its first token, then the rest
   arrive. Fails unless: hits >= 6, prefill tokens skipped >= 6 x 1024 and
   copy-on-write copies >= 1; the system prompt's blocks are bit-equal
   before the hits and after the wave (crc32 printed) and the
   copy-on-write block equals its source's kept slots; a hit's last-token
   logits (20 tokens after 1,024 cached: the per-token decode kernel) are
   within ``LOGITS_REL_L2_TOL`` of a cold put on an engine with the cache off
   sharing the weights, and so are those of a prompt that leaves the system
   prompt at token 1000 with a fresh suffix of request 5's length (a
   copy-on-write hit of 1,000 tokens, the q-tiled prefill from there); the
   tree demoted to the host tier and hit again
   promotes the system chain bit-equal to its pre-demotion copy, logits
   within the same tolerance; the sampler on a 32,000-entry row (logits
   -log(1 + rank), 20,000 draws at positions 0..19,999) draws nothing
   outside the nucleus and passes a chi-square test (p > 1e-3) over the
   filtered softmax's top 64 tokens and one bucket for the rest; the wave
   replayed on a fresh engine gives identical streams. Then a short-context
   wave on an engine sharing the weights (max_context 448: tables of 7
   blocks, under the split decode's 8): 8 requests on a 256-token system
   prompt with suffixes of 32-96 tokens, 32 new tokens each, the even ones
   sampled; every generation whole and hits >= 7. The launch counts are
   set to 0 just before each wave and read just after it: the paged
   prefill, the split decode and its merge must launch in the first (its
   sampled and greedy horizons split), the paged prefill and the per-token
   decode in the short-context one (its horizons, sampled and greedy, take
   the per-token kernel). Printed: TTFT of the hit and the cold put, the
   promotion's time, decode ms/step of sampled against greedy horizons (in
   turns, on both engines), the sampler's time, peak memory, beside the
   card's name and power limit.
20. families: the model families on the paged kernels, each engine freed
   before the next (bf16, random weights from seed 0, kv block 64,
   max_context 2048). Qwen2-7B at full width and depth through
   ``build_model_engine("qwen2", "7b")`` (28 layers, GQA 28/4: 7 query
   heads a kv head, so the prefill's tile is 9 tokens; biased qkv, rope
   theta 1e6, vocab 152,064), and Bloom-7b1 at full width with its depth
   cut 30 -> 4 through ``build_engine(bloom("7b1", num_layers=4))`` (MHA
   32/32, head_dim 128, ALiBi on every paged route, embedding LayerNorm,
   LayerNorm, GELU, biases, a tied 250,880 vocabulary): each serves the two
   waves of ``e2e`` (the launch counts set to 0 just before and read just
   after; the per-token decode, the split decode and its merge, and the
   q-tiled prefill must each launch), its 512-token prefill logits must be
   within ``LOGITS_REL_L2_TOL`` of the plain route's on the same weights,
   and a decode profile gives wall and device ms per step. Then the HF
   loader's round trip: a Qwen2-7B-width checkpoint of 2 layers in HF
   naming, drawn from seed 20 on the card and written as bf16
   ``.safetensors`` in two shards plus ``config.json`` into a temporary
   directory (removed afterwards), is loaded by ``build_hf_engine``; every
   loaded tensor must equal what was written (after its transpose, bit for
   bit), and a 512-token put's logits must be within the same tolerance of
   the plain route's. Three presets at other head dims and group sizes
   serve the same waves with the same checks, at full width with their
   depth cut: phi-2 (head_dim 80, 32 -> 4 layers) through
   ``build_model_engine("phi", "2")``, Falcon-7B (71 query heads over 1 kv
   head, 32 -> 4) and GPT-J-6B (head_dim 256, 28 -> 2) through
   ``build_engine``. Last, ``build_model_engine("phi", "tiny",
   num_layers=1)`` (head_dim 32, a CPU-only preset) must raise at engine
   build, naming the head dim. Printed: TTFT p50,
   decode ms/step wall and device, peak memory, the load's seconds and
   GB/s (the files just written: a warm read) and the host's resident
   memory before it and at most during it (sampled every 2 ms), beside the
   card's name and power limit.
21. families_train: training at the families' head dims through
   ``initialize`` and ``train_batch`` on the train phase's recipe (bf16,
   fused AdamW, clipping, WarmupLR; gas 2 of 1 x 2048 tokens), random
   weights from seed 0, at full width with the depth cut: phi-2 (head_dim
   80) 32 -> 2 layers, GPT-NeoX-20B (96) 44 -> 2, GPT-J-6B (256) 28 -> 2,
   each freed before the next. A warm step, then 3 timed ones with the
   launch counts set to 0 just before: ``flash_fwd``, ``flash_bwd_dq`` and
   ``flash_bwd_dkdv`` must each launch layers x microbatches x steps times
   and ``fused_adam`` once a step; the losses must be finite and falling;
   the loss and the whole gradient at seq 1024 must be within
   ``LOSS_REL_TOL`` / ``GRAD_REL_L2_TOL`` of the plain attention's on the
   same weights; ``init_inference(...).forward`` at the same width must
   launch the flash forward once a layer. Last, phi's tiny preset (head_dim
   32) must be refused at ``initialize``, naming the head dim. Printed: step
   ms, tokens/s, peak memory, beside the card's name and power limit.

22. offload: ZeRO-Offload through ``initialize`` / ``train_batch`` at
   Mistral-7B's widths, seq 2048, the train phase's recipe without its
   warm-up schedule (bf16, AdamW lr 1e-4, clipping, gas 2). (a) The host:
   ``MemTotal`` / ``MemAvailable``, CPUs, free space under ``build/``; the
   C++ Adam (``DeepSpeedCPUAdam``) over 2.007e9 fp32 elements (its second
   call timed: ms and GB/s of 28 B an element); ``AsyncIOHandle`` writing
   and reading 1 GiB under ``build/`` (read back equal). (b) 8 layers, 3
   steps on one seeded batch, under device AdamW (the fused kernel), under
   ``offload_optimizer: cpu`` and under ``cpu`` with ``ratio: 0.5``: each
   offloaded run's losses within ``LOSS_REL_TOL`` of the device run's, its
   parameters within ``OFFLOAD_PARAM_REL_TOL`` (1e-2) of the device run's
   as a fraction of what the steps moved them, its flash launches equal,
   and full offload's device peak at least 0.9 x 8 B a parameter below the
   device run's (printed: the split of each step into forward / backward
   with the norm, gradient D2H wait, host Adam and upload tail; set-up
   times). (c) 2 layers, 2 steps, moments on NVMe under a temporary
   directory in ``build/``: the parameters and losses equal ``cpu``
   offload's bit for bit. (d) ``OFFLOAD_FULL_LAYERS`` (10; 32, with
   ``remat``, ran in PR 23's runs 1 and 3-5 but takes ~60 s alone, past the
   phase's 90 s), 2 steps of ``cpu`` offload, refused below the host memory
   it needs: device peak, host resident peak (sampled every 10 ms), the step
   split, flash launches, falling losses. Printed beside the card's name
   and power limit; the flash kernels' JSON entries gain
   ``offload_launches`` a run.
23. pipe_onebit: the 1-bit optimizers and the pipeline through
   ``initialize`` / ``train_batch`` at Mistral-7B's widths, seq 2048, bf16,
   one spawned world (two gloo ranks sharing the card; with four cards,
   four NCCL ranks). 1-bit (``OneBitAdam`` at ZeRO stage 0, ``OneBitLamb``
   and ``ZeroOneAdam`` at stage 1; data = the world, 2 layers at vocab
   ZERO_VOCAB; 8 layers over four cards, ``OneBitAdam`` only), freeze_step
   1 and 3 steps: the exact step against the stage-0 data-parallel step of
   the same world (``dp:adam``, AdamW) within ``ZERO_WORLD1_REL_TOL``; the
   compressed exchange of three JAX leaves (``ONEBIT_CHECKED``) recomputed
   in this process from every rank's local gradients, the check carrying
   its own error buffers, within ``ONEBIT_CHECK_REL_TOL`` of each rank's
   mean and new error buffers; the bytes a rank sends for the exact (a
   ring all-reduce) and the compressed exchange, computed from the sizes;
   each step's ms. Pipeline (1F1B and GPipe, ``pipe`` 2 at 4 layers, the
   32,000 vocabulary, gas 4, 3 steps, fused AdamW; over four cards ``pipe``
   4, and ``pipe`` 2 x ``data`` 2 under both schedules, at 8 layers; each
   rank draws its stage alone, ``TransformerLM(pipe_stage=...)``): losses
   and gradient norms against the whole model drawn from the same seed at
   world size 1 on the same global batch within ``ZERO_WORLD1_REL_TOL``,
   GPipe against 1F1B within ``ZERO_REL_TOL``, each rank's stage, peak
   memory building the stage and ``initialize`` and in the steps, and most
   live microbatches. The flash kernels' launches on every
   rank (layers a rank x gas x steps) and fused AdamW's on the pipeline
   ranks (none under 1-bit), reset just before the steps; rows 4-7's JSON
   entries gain ``pipe_onebit_launches`` (per case, per rank).

``--mutant`` copies the package into ``build/mutant/<name>`` once per
mutant: the grouped matmul kernels dropping one row block's products
(``--phases build,moe_kernels`` there must fail), the tensor-core
block-sparse kernel with each warp skipping its row's last LUT column
and, alone, the fp32 one skipping each row's last valid LUT column (``--phases
build,sparse_kernels`` must fail by more than 100x its tolerance,
printed), the tensor-core
Evoformer db2 skipping each row chunk's last row and, alone, the
tensor-core Evoformer dk/dv skipping each head's last query tile, the
tensor-core Evoformer forward skipping each CTA's last key tile, and
the tensor-core Evoformer dq doing the same (``--phases
build,evo_kernels``, the same), the flash backward with
dk/dv skipping each CTA's last live q-tile and dq its last live k-tile
and, alone, the flash forward skipping each CTA's last live k-tile and,
alone, the d 256 flash dk/dv whose second warp of each row block stores
none of its 128 output dims (``--phases build,train_kernels``, the same),
the paged prefill
skipping each CTA's last live k-tile and, alone, the paged decode
skipping each split's last live block and, alone, the paged decode
dropping the last head tile of every (token, kv head) with more than one
(Falcon-7B's heads 64-70: zeros, m -1e30, l 0; ``--phases
build,kernels``, the same), and the v1 path with its identity table's block base shifted by one
block (``--phases build,v1`` must fail on the logits), and the ZeRO
partition with rank 1 gathering the head group's updated shards into a
scratch copy after each update, so that it trains on a stale half of the
head, and the same for the first block's (``--phases build,zero`` must
fail, each by more than 30x the phase's tolerance), and the MoE at world
size >= 2 with the einsum path's return all-to-all rotating the slots by
one rank and, alone, the grouped path's expert gradients kept on each
owner's own tokens (not reduce-scattered; ``--phases build,moe_zero``
must fail by more than 30x the phase's tolerance), and the activation
checkpoint restoring no generator before its recompute (``--phases
build,remat`` must fail on the MoE check by more than 30x its tolerance),
and tensor parallelism with the column region's backward summing nothing
over the model group and, alone, every rank's serving weights taking rank
0's kv heads (``--phases build,tp`` must fail, each by more than 30x the
phase's tolerance), and the host offload optimizer updating its masters
but uploading nothing (``--phases build,offload`` must fail by more than
30x the parity tolerance), and a pipeline stage receiving the previous
microbatch's activation and, alone, the 1-bit exchange dropping the
server's error (``--phases build,pipe_onebit`` must fail, each by more than
30x the phase's tolerance): twenty-four copies.
It passes when every mutant is caught.

``--ablation`` times the flash kernels, the paged prefill and decode, the
grouped matmul and the Evoformer kernels against copies under
``build/ablation/<name>``, each undoing one design choice of
``ABLATIONS`` (the grid order of the backward and of the forward, the
prefill's tile order, the mask fast path, the two-level accumulation, each
split pair, dk/dv's 16-query chunks; the decode split over the table's capacity, as the TPU grid
splits it, with its plain partials patched alike; the grouped matmul's ring
two stages deep, one CTA per tile; db2's rows in one chunk; the
Evoformer forward and dq with two rows n a CTA sharing each staged
pair-bias tile, not one; the block-sparse forward with each warp walking
its own row's LUT columns, not a CTA's warps the union of theirs):
``--phases
kernels,train_kernels`` (``kernels`` alone for the decode,
``moe_kernels`` for the grouped matmul, ``sparse_kernels`` for the
block-sparse forward's, ``evo_kernels`` for the Evoformer's) in every copy
in turns, each version twice,
printing the main shapes' times and each phase's largest error as a
fraction of the tolerance (``worst_error_fraction``; above 1 fails that
check). ``--mutant`` and ``--ablation`` take an optional comma-separated
subset of names.

``--versus DIR`` times this tree against another checkout of the
repository (e.g. ``git archive <parent> | tar -x -C build/parent``), each
with its kernels built at once: ``--phases`` (default ``kernels,e2e``) in
the order DIR, this, this, DIR, each tree's own script for every phase but
``e2e``, which runs this script's ``phase_e2e`` on each tree's package (so
the serving path is measured by the same code on both), printing the paged
decode times, the serving decode profile (wall and device ms per step,
device kernels per step), decode tok/s and TTFT p50, the grouped matmul's,
the Evoformer kernels' and the block-sparse forward's times (both routes),
the flash kernels' times at the training shape (``train_kernels``),
the dense training step (``train``, world size 1), the MoE step, the
Evoformer block, the block-sparse training step and their top device ops
per run, and one JSON line of all runs.

It prints the card (name and power limit) and, on the line before the last,
``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It exits non-zero, printing no result, without a CUDA card or without the
rest of the repository beside it. ``--phases`` runs a subset and prints
no result lines.
"""

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12  # fp32 peak outside the tensor cores, NVIDIA data sheet
TOL_ULPS, TOL_FLOOR = 2, 2.0**-14
LOGITS_REL_L2_TOL = 5e-2
SOURCE = "deepspeed_tpu_torch/ops/csrc/paged_attention.cu"
TPU_SRC = "deepspeed_tpu/ops/pallas/paged_attention.py"
KERNELS = {  # name -> (TPU kernel it replaces)
    "paged_decode": f"{TPU_SRC}:258",
    "paged_decode_split": f"{TPU_SRC}:550",
    # the split's log-sum-exp merge, jnp ops after _paged_kv_split's pallas_call
    "paged_decode_merge": f"{TPU_SRC}:700",
    "paged_prefill": f"{TPU_SRC}:394",
}
# the split decode's fp32 partials: m within 2^-14 (1 + |m|), l within 2^-14 l,
# acc within 2^-14 l max|v| (see the module docstring)
PARTIAL_TOL = 2.0**-14
# (kv heads, group size, head_dim) of the small matrix's model-family cases:
# g 1 at every head dim (Bloom, GPT-2, OPT at 64 / 128; phi-2 80, GPT-NeoX-20B
# 96, GPT-J-6B and Pythia 256), Qwen2's g 7, Falcon-7B's 71 over one kv head
# and Falcon-40B's 16; each plain and with ALiBi slopes, bf16 pools, and at
# FAMILY_INT8_DIMS int8 pools as well
FAMILY_GROUP_CASES = ((4, 1, 64), (4, 1, 128), (2, 7, 128), (4, 1, 80), (4, 1, 96), (2, 1, 256),
                      (1, 71, 64), (2, 16, 64))
FAMILY_INT8_DIMS = (80, 256)
# the presets at head dims 80 / 96 / 256 and group sizes over 8, at their head
# shapes (name, query heads, kv heads, head_dim): the paged routes timed at the
# main path's sizes
FAMILY_SHAPES = (("phi-2", 32, 32, 80), ("GPT-NeoX-20B", 64, 64, 96), ("GPT-J-6B", 16, 16, 256),
                 ("Pythia-1B", 8, 8, 256), ("Falcon-40B", 128, 8, 64), ("Falcon-7B", 71, 1, 64))
FLASH_SRC = "deepspeed_tpu_torch/ops/csrc/flash_attention.cu"
TPU_FLASH = "deepspeed_tpu/ops/pallas/flash_attention.py"
TRAIN_KERNELS = {  # name -> (source, TPU kernel it replaces)
    "flash_fwd": (FLASH_SRC, f"{TPU_FLASH}:237"),
    "flash_bwd_dkdv": (FLASH_SRC, f"{TPU_FLASH}:414"),
    "flash_bwd_dq": (FLASH_SRC, f"{TPU_FLASH}:483"),
    "fused_adam": ("deepspeed_tpu_torch/ops/csrc/fused_adam.cu",
                   "deepspeed_tpu/ops/pallas/fused_adam.py:47"),
}
GRAD_FLOOR_RMS = 2.0**-12  # flash tolerance floor, as a fraction of rms(plain)
# rows 4-6 at the presets' attention shapes (name, query heads, kv heads,
# head_dim), B 1, S FLASH_FAMILY_SEQ (their max_seq_len), causal: checked
# and timed beside their bounds and SDPA. Falcon-7B's dk/dv grid is nkv x
# S / 64 = 32 CTAs on 132 SMs.
FLASH_FAMILY_SHAPES = (("phi-2", 32, 32, 80), ("GPT-NeoX-20B", 64, 64, 96),
                       ("GPT-J-6B", 16, 16, 256), ("Pythia-1B", 8, 8, 256),
                       ("Falcon-7B", 71, 1, 64))
FLASH_FAMILY_SEQ = 2048
ADAM_RTOL = 1e-6
# the training phase (Mistral-7B width, depth cut for memory)
TRAIN_LAYERS, TRAIN_SEQ, CHECK_SEQ, TIMED_STEPS = 8, 4096, 1024, 4
TRAIN_DS_CONFIG = {
    "train_batch_size": 2, "train_micro_batch_size_per_gpu": 1, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
    # WarmupLR's warmup_max_lr defaults to 1e-3 and would override the
    # optimizer's lr; named here so the schedule warms up to 1e-4
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 2, "warmup_max_lr": 1e-4}},
    "gradient_clipping": 1.0, "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
    "tpu": {"pallas_fused_adam": "always"}, "steps_per_print": 1000,
}
# kernels vs plain attention on the same weights at seq 1024: the two
# attention outputs differ in the last bf16 bit, and later bf16 roundings
# through 8 layers (forward and backward) amplify that
LOSS_REL_TOL, GRAD_REL_L2_TOL = 2e-3, 5e-2
GMM_SRC = "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu"
TPU_GMM = "deepspeed_tpu/ops/pallas/grouped_matmul.py"
MOE_KERNELS = {"gmm": (GMM_SRC, f"{TPU_GMM}:85"), "tgmm": (GMM_SRC, f"{TPU_GMM}:148")}
# the MoE training phase: Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1
# config.json: hidden 4096, intermediate 14336, 32/8 heads, vocab 32000, 8
# experts, top-2, rope_theta 1e6, no sliding window), depth cut 32 -> 2
MOE_LAYERS = 2
MOE_CONFIG = dict(sliding_window=None, rope_theta=1e6, moe_num_experts=8, moe_top_k=2,
                  moe_impl="grouped", num_layers=MOE_LAYERS)
# tgmm's fp32 sums: a floor of 2^-16 * sqrt(rows summed) * rms(plain[e])
TGMM_FLOOR = 2.0**-16
# the serving modules at Mixtral width: relative L2 of grouped vs dense
MOE_SERVE_REL_L2_TOL = 1e-2
BSA_SRC = "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu"
SPARSE_KERNELS = {"block_sparse_fwd": (BSA_SRC,
                                       "deepspeed_tpu/ops/pallas/block_sparse_attention.py:196")}
# the block-sparse training phase: Llama-2-7B's widths (meta-llama/Llama-2-7b-hf
# config.json: hidden 4096, intermediate 11008, 32/32 heads, vocab 32000,
# RMSNorm 1e-5, rope 1e4, untied), depth cut 32 -> 8, and the sparse-attention
# block of DeepSpeed's documented ds_config (docs/_pages/config-json.md,
# "Sparse Attention") with "unidirectional" for a causal LM
SPARSE_LAYERS = 8
SPARSE_SA = {"mode": "fixed", "block": 16, "different_layout_per_head": True,
             "num_local_blocks": 4, "num_global_blocks": 1, "horizontal_global_attention": False,
             "num_different_global_patterns": 4, "attention": "unidirectional"}
SPARSE_DS_CONFIG = dict(TRAIN_DS_CONFIG, sparse_attention=SPARSE_SA)
EVO_SRC = "deepspeed_tpu_torch/ops/csrc/evoformer_attention.cu"
EVO_PY = "deepspeed_tpu_torch/ops/evoformer_attention.py"
TPU_EVO = "deepspeed_tpu/ops/pallas/evoformer_attention.py"
EVO_KERNELS = {  # name -> the TPU kernel it replaces (db1 is summed inside the dk/dv kernel)
    "evo_fwd": f"{TPU_EVO}:113", "evo_bwd_dq": f"{TPU_EVO}:231",
    "evo_bwd_dkdv": f"{TPU_EVO}:265", "evo_bwd_db1": f"{TPU_EVO}:346",
    "evo_bwd_db2": f"{TPU_EVO}:306"}
# the v1 path: Mistral-7B at full width and depth through init_inference, two
# waves of (prompts, prompt tokens, new tokens): Smax 128 (one 128-slot block a
# table: the prefill kernel and the per-token decode) and Smax 1024 (eight
# blocks: the prefill and the split decode with its merge); then one forward
V1_WAVES = ((4, 20, 44), (8, 960, 64))
V1_FORWARD = (1, 2048)
V1_PROFILE_STEPS = 8
# the hybrid engine on the train phase's configuration, at a constant lr (the
# WarmupLR of TRAIN_DS_CONFIG is 0 for the first two steps, which would leave
# the view unchanged); rollouts of HYBRID_NEW tokens after HYBRID_PROMPT prompts
HYBRID_DS_CONFIG = dict({k: v for k, v in TRAIN_DS_CONFIG.items() if k != "scheduler"},
                        hybrid_engine={"enabled": True})
HYBRID_PROMPT, HYBRID_NEW = (4, 64), 32
# ZeRO at data-parallel world size >= 2: Mistral-7B's width, bf16, fused AdamW,
# clipping 1.0, gas 2, 1 x ZERO_SEQ tokens a rank a microbatch, every stage
# ZERO_STEPS steps from the same weights, at a constant lr 1e-3 so that the
# losses move by whole nats (the ids come from ZERO_VOCAB tokens) and a rank
# working on stale weights shows in them. Depth 2 when gloo ranks share one
# card (gloo copies every collective through the host), 8 over NCCL (as the
# train phase), and 32 at stage 3 over four cards.
# The ranks' timeout leaves room for a slow host: the one-card gloo spawn
# has taken 362 s.
ZERO_SEQ, ZERO_STEPS, ZERO_VOCAB, ZERO_TIMEOUT_S = 2048, 3, 256, 600
ZERO_GLOO_LAYERS, ZERO_NCCL_LAYERS, ZERO_FULL_LAYERS = 2, 8, 32
ZERO_DS_CONFIG = dict({k: v for k, v in TRAIN_DS_CONFIG.items() if k != "scheduler"},
                      optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
                      train_batch_size=None)
# stages 1-3 against stage 0 (losses and gradient norms, each rank): one
# computation in other places, fp32 sum orders apart (the sound runs' worst
# on H100: 2.1e-5 with two gloo ranks on one card, 7.0e-6 with four NCCL
# ranks). Stage 0 at world size N against the world-size-1 engine on the
# same global batch (micro N): each rank's weight gradients are rounded to
# bf16 before the sum over ranks, not after.
ZERO_REL_TOL, ZERO_WORLD1_REL_TOL = 2e-4, 2e-3
# Tensor parallelism (tp): the zero phase's training configuration over the
# model axis, held to world size 1 on the same global batch within
# ZERO_WORLD1_REL_TOL (each rank's row-parallel partial products are rounded
# to bf16 before their sum, not after): model 2 x data 1 at depth
# TP_GLOO_LAYERS when two gloo ranks share one card (every all-reduce goes
# through the host), and over four cards data 2 x model 2 at stages 1 and 3
# (stage 3 also held to stage 1 within ZERO_REL_TOL) and data 1 x model 4 at
# depth ZERO_NCCL_LAYERS, then stage 3 at full depth. Serving:
# init_inference(tensor_parallel tp_size = the ranks) at full depth on the v1
# waves against tp_size 1 on the same weights in this process: the prefill's
# last-token logits within LOGITS_REL_L2_TOL, and each rank's first-layer
# cache (its kv heads at the prompt's positions) within TP_KV_REL_TOL: those
# keys and values come from the same embedding rows and norm through a column
# slice of the same weights, so only the products' fp32 sum order (another
# GEMM tile over a slice of the columns) may differ, rounding to bf16 a last
# bit apart at some elements.
TP_GLOO_LAYERS, TP_KV_REL_TOL = 2, 1e-2
# the train phase's fused AdamW (lr 1e-4, weight decay 0.1) at a constant lr
# (TRAIN_DS_CONFIG's WarmupLR is 0 for the first two steps): at the zero
# phase's lr 1e-3 the sign-like first AdamW updates carry the two sides'
# bf16 roundings into trajectories that part (PERF.md, tensor parallelism)
TP_DS_CONFIG = dict({k: v for k, v in TRAIN_DS_CONFIG.items() if k != "scheduler"},
                    train_batch_size=None)
# MoE at data-parallel world size >= 2 (moe_zero): Mixtral-8x7B's widths
# (MOE_CONFIG) on the zero phase's training configuration, the experts over the
# ranks; the gating draws from each row's generator (top-2's Gumbel second
# expert). Depth 1 when gloo ranks share one card (the grouped path moves 2.8 GB
# of gathered experts and 5.6 GB of their fp32 gradients a layer a microbatch
# through the host), 2 over NCCL against world size 1 (50.6 GB of state on one
# card), then 8 with the experts over 4 cards (45.1 GB of expert state a rank)
# at stages 0 and 3, without world size 1, which one card does not hold. Each
# case is impl:stage.
MOE_ZERO_GLOO_LAYERS, MOE_ZERO_NCCL_LAYERS, MOE_ZERO_EP_LAYERS = 1, 2, 8
MOE_ZERO_CASES = ("einsum:1", "grouped:3")
MOE_ZERO_STEPS = 2
MOE_ZERO_EP_CASES = ("einsum:0", "einsum:3", "grouped:0", "grouped:3")
# Gradient norms where no token routes otherwise: against world size 1 (the
# counted routing flips 0; sound runs 1.5e-4 to 1.1e-3 on H100) and einsum
# against grouped at the first step, on the same weights (1.0e-3 at depth 8).
# A wrong expert gradient (the moe_expert_grad mutant) reads 1.3e-1.
# After an lr 1e-3 AdamW step the two impls' trajectories part at world size
# 1 too (depth 2: losses 4e-5 -> 1.4e-3): the first update moves every
# element by about lr times the sign of its gradient, and the bf16 gradients
# of the two impls differ in sign where they are near 0. So einsum and
# grouped are compared at the first step only; each impl's later steps are
# held to world size 1 and, at depth 8, stage 3 to stage 0 (ZERO_REL_TOL).
MOE_NORM_REL_TOL = 1e-2
# the Evoformer path: AlphaFold-2's fine-tuning crop (AF2 supplementary
# information, Table 4: N_res 384, N_clust 512) with OpenFold's Evoformer
# heads (c_hidden_msa_att 32 x 8 heads, c_hidden_pair_att 32 x 4 heads);
# (name, n_seq, n_res, heads, pair bias) of one block's four calls
EVO_RES, EVO_SEQ, EVO_D = 384, 512, 32
EVO_CALLS = (("msa_row", EVO_SEQ, EVO_RES, 8, True),  # AF2 Alg. 7, with the pair bias
             ("msa_col", EVO_RES, EVO_SEQ, 8, False),  # Alg. 8
             ("tri_start", EVO_RES, EVO_RES, 4, True),  # Alg. 13
             ("tri_end", EVO_RES, EVO_RES, 4, True))  # Alg. 14, the transposed pair
EVO_MASK_INF = 1e9  # OpenFold's mask bias: inf * (mask - 1) with inf 1e9
EVO_ITERS = 3
# fp32 outputs: both sides sum in fp32 in another order and never round to
# a narrower type
EVO_FP32_REL, EVO_FP32_RMS = 2.0**-16, 2.0**-14
# every gradient also gets 2^-18 of its sum over absolute terms: summing n
# terms in another order moves the result by at most ~n 2^-24 of that sum
EVO_ABS_TERMS = 2.0**-18
# the whole path, kernels vs plain: the two outputs differ in the last bf16
# bit at some elements, and each backward reads its own output (delta =
# rowsum(dO * O))
EVO_PATH_REL_L2_TOL = 1e-2
# one MoE layer at seq 1024, kernels vs the plain grouped path on one input
# (identical routing): bf16 roundings of up / gate / activation / down at the
# same places from fp32 sums in another order, each differing in the last
# bit at most
MOE_LAYER_REL_L2_TOL = 1e-2
# the whole MoE model at seq 1024: the last layer's gate sees inputs that
# differ in the last bf16 bit, and a token whose top-2 margin is below that
# changes experts (and the capacity ranks behind it), so whole tokens'
# contributions move between experts' gradients
MOE_GRAD_REL_L2_TOL = 1.5e-1
# activation checkpointing (remat) on the train phase's configuration: the
# policies the remat phase drives (each held against remat off on one
# microbatch, then timed over REMAT_STEPS train_batch steps), and the
# tolerance of those gradients' relative L2 distance: the recompute runs the
# same kernels on the same inputs, so it is 0 wherever every op sums in a
# fixed order; 1e-5 leaves room for an op that sums by atomics (the grouped
# MoE path's index_add), far below what a token routed otherwise moves. The
# MoE check at Mixtral-8x7B's widths, REMAT_MOE_LAYERS deep, the grouped path
# with top-2's Gumbel second expert drawn from each row's generator.
REMAT_POLICIES = ("nothing_saveable", "dots_saveable", "save_only_these_names(attn_out)")
REMAT_STEPS, REMAT_REL_TOL, REMAT_MOE_LAYERS = 3, 1e-5, 2
# the eager phase: EAGER_STEPS forward / backward / step steps against as many
# train_batch steps from the same seed (the same per-microbatch code: equal,
# or within EAGER_REL_TOL of the parameters' norm where an op sums by atomics)
EAGER_STEPS, EAGER_REL_TOL = 2, 1e-6
# the prefix_sample phase: Mistral-7B served with the prefix cache (a host
# tier under it) to 8 requests sharing a 1,024-token system prompt, each with
# a suffix of 64-200 tokens; request 5 leaves the system prompt at token
# 1000 (mid-block: copy-on-write), request 7 repeats request 0's prompt;
# the even ones sample (temperature 0.8, top_p 0.95, seed 1000 + uid)
PREFIX_SYSTEM, PREFIX_SPLIT, PREFIX_REQUESTS, PREFIX_NEW = 1024, 1000, 8, 32
PREFIX_POOL_BLOCKS, PREFIX_HOST_BLOCKS, PREFIX_BATCH = 256, 64, 1536
PREFIX_KNOBS = dict(temperature=0.8, top_p=0.95)
PREFIX_DECODE_STEPS = 16  # the timed horizons, sampled against greedy
# the short-context wave: max_context 448 makes every block table 7 blocks
# wide, under the split decode's 8, so its decode horizons (sampled and
# greedy) take the per-token kernel; 8 requests on a 256-token system prompt
# with suffixes of 32-96 tokens and 32 new tokens each, the even ones sampled
PREFIX_SHORT_SYSTEM, PREFIX_SHORT_CONTEXT, PREFIX_SHORT_BLOCKS = 256, 448, 64
# the sampler's distribution check: a 32,000-entry row with logits -log(1 + rank)
# (randomly permuted), 20,000 draws at positions 0..19,999, chi-square over
# the filtered softmax's top 64 tokens and one bucket for the rest of the nucleus
CHI2_VOCAB, CHI2_DRAWS, CHI2_TOP, CHI2_MIN_P = 32000, 20000, 64, 1e-3
# phase 20: the model families. Qwen2-7B at full size; Bloom-7b1 at full
# width with its depth cut 30 -> 4; a Qwen2-7B-width HF checkpoint of 2
# layers written in two bf16 .safetensors shards and loaded back
FAMILIES_QWEN = ("7b", {})
FAMILIES_BLOOM = ("7b1", {"num_layers": 4})
# served at full width with their depth cut: phi-2 (d 80) 32 -> 4, Falcon-7B
# (71 query heads over 1 kv head) 32 -> 4, GPT-J-6B (d 256) 28 -> 2
FAMILIES_PHI = ("2", {"num_layers": 4})
FAMILIES_FALCON = ("7b", {"num_layers": 4})
FAMILIES_GPTJ = ("6b", {"num_layers": 2})
FAMILIES_HF_LAYERS, FAMILIES_HF_SHARDS = 2, 2
# phase 22: training at the families' head dims through initialize and
# train_batch on TRAIN_DS_CONFIG's recipe, at full width with the depth cut
# (name -> family, preset, layers): phi-2 (d 80) 32 -> 2, GPT-NeoX-20B (d 96;
# 1.5B fp32 masters at 2 layers, ~25 GB with grads and moments) 44 -> 2,
# GPT-J-6B (d 256) 28 -> 2; a warm step and FAMILIES_TRAIN_STEPS timed ones
# at seq FAMILIES_TRAIN_SEQ (the presets' max_seq_len)
FAMILIES_TRAIN = {"phi_2": ("phi", "2", 2), "gpt_neox_20b": ("gpt_neox", "20b", 2),
                  "gptj_6b": ("gptj", "6b", 2)}
FAMILIES_TRAIN_SEQ, FAMILIES_TRAIN_STEPS = 2048, 3


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=50, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def bound_ms(n_bytes, flops, peak_flops=BF16_FLOPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def _log_ptxas(report, tag="[build]", keep=None):
    """Each kernel's registers and spills from nvcc's ``-Xptxas -v`` report
    (only kernels whose name holds one of ``keep``, when given)."""
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            if keep is not None and not any(k in name for k in keep):
                name = None
        elif "Used" in line and "registers" in line and name:
            log(f"{tag}   {name}: {line.split(':', 1)[1].strip()}")
        elif "spill" in line and name:
            log(f"{tag}   {name}: {line.strip()}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import evoformer_attention as tev
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa

    from deepspeed_tpu_torch.ops import aio
    from deepspeed_tpu_torch.ops.adam import cpu_adam

    mods = {"paged_attention": pa, "flash_attention": fa, "fused_adam": fad, "grouped_matmul": gm,
            "block_sparse_attention": bsa, "evoformer_attention": tev}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods) + 2) as ex:  # one nvcc per source, all at once
        hosts = [ex.submit(m._lib) for m in (cpu_adam, aio)]  # the host ops' g++ alongside
        built = dict(zip(mods, ex.map(lambda m: m.kernel_build(), mods.values())))
        for h in hosts:
            h.result()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.2f}s ({len(built)} sources "
        f"built in parallel)")
    for stem, b in built.items():
        log(f"[build] {stem}: nvcc {b.seconds:.2f}s -> {os.path.relpath(b.path, HERE)}")
        _log_ptxas(b.ptxas)
    plib = built["paged_attention"].lib
    log(f"[build] paged attention dynamic shared memory per CTA at the main path's shapes (d "
        f"128, block 64): decode bf16 pools {plib.ds_paged_smem_bytes(128, 0)} B, int8 pools "
        f"{plib.ds_paged_smem_bytes(128, 1)} B, prefill (64 rows = q_tile 16 x g 4) bf16 pools "
        f"{plib.ds_paged_prefill_smem_bytes(128, 0)} B, int8 pools "
        f"{plib.ds_paged_prefill_smem_bytes(128, 1)} B")
    fsm = built["flash_attention"].lib.ds_flash_smem_bytes
    log(f"[build] flash attention dynamic shared memory per CTA (d 128): forward {fsm(0, 128)} "
        f"B, dk/dv {fsm(1, 128)} B, dq {fsm(2, 128)} B")
    bsm = built["block_sparse_attention"].lib.ds_block_sparse_smem_bytes
    log(f"[build] block-sparse forward dynamic shared memory per CTA: tensor cores d 128 "
        f"{bsm(0, 128)} B, d 64 {bsm(0, 64)} B; fp32 route d 128 {bsm(1, 128)} B, d 64 "
        f"{bsm(1, 64)} B")
    esm = built["evoformer_attention"].lib.ds_evo_smem_bytes
    log(f"[build] Evoformer dynamic shared memory per CTA (d 32): tensor cores forward "
        f"{esm(6, 32)} B (d 128 {esm(6, 128)} B), dq {esm(7, 32)} B (d 128 {esm(7, 128)} B), "
        f"dk/dv {esm(4, 32)} B (d 128 {esm(4, 128)} B), db2 {esm(5, 32)} B (d 128 "
        f"{esm(5, 128)} B); fp32 route forward {esm(0, 32)} B, dq {esm(1, 32)} B, dk/dv "
        f"{esm(2, 32)} B, db2 {esm(3, 32)} B")


# ---------------------------------------------------------------------------
# phase 2: kernels against the plain version
# ---------------------------------------------------------------------------

def _make_case(seed, nkv, g, d, bs, tables, seq_idx, pos, int8):
    """Pools with one trailing scratch slot (as the engine's), random
    values from a seeded generator; int8 pools quantized per (slot, head)
    like the engine's append."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_slots = (int(tables.max()) + 1) * bs + 1
    kf = torch.randn(n_slots, nkv, d, generator=gen, device=dev)
    vf = torch.randn(n_slots, nkv, d, generator=gen, device=dev)
    q = torch.randn(seq_idx.numel(), nkv * g, d, generator=gen, device=dev).to(torch.bfloat16)
    kw = {}
    if int8:
        ks = (kf.abs().amax(-1) / 127).clamp_min(1e-8)
        vs = (vf.abs().amax(-1) / 127).clamp_min(1e-8)
        k = torch.round(kf / ks[..., None]).to(torch.int8)
        v = torch.round(vf / vs[..., None]).to(torch.int8)
        kw = dict(k_scale=ks.t().contiguous(), v_scale=vs.t().contiguous())
    else:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    return q, k, v, tables.to(dev), seq_idx.to(dev), pos.to(dev), kw


def bf16_ulp(x):
    """Spacing of bfloat16 numbers (8 significant bits) at |x|."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def _err(out, ref):
    """(max |out - ref|, the largest error as a fraction of its element's
    tolerance); the check passes when the fraction is at most 1."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    return float(err.max()), float((err / (TOL_ULPS * bf16_ulp(ref) + TOL_FLOOR)).max())


def _partials_err(got, ref, vmax):
    """(max |acc - plain acc|, the largest error of the split decode's
    partials as a fraction of its tolerance): m within 2^-14 (1 + |m|), l
    within 2^-14 l, acc within 2^-14 l max|v| (module docstring)."""
    (acc, m, l), (racc, rm, rl) = got, ref
    fracs = ((m - rm).abs() / (PARTIAL_TOL * (1 + rm.abs())),
             (l - rl).abs() / (PARTIAL_TOL * rl).clamp_min(1e-30),
             (acc - racc).abs() / (PARTIAL_TOL * vmax * rl[..., None]).clamp_min(1e-30))
    return float((acc - racc).abs().max()), max(float(f.max()) for f in fracs)


def _vmax(v, kw):
    """The largest |value| of a pool, dequantised."""
    if "v_scale" in kw:
        return float((v.float() * kw["v_scale"].t()[:, :, None]).abs().max())
    return float(v.float().abs().max())


def _reference_in_chunks(pa, q, k, v, tb, si, po, bs, rows=16):
    """``paged_attention_reference`` over ``rows`` query tokens at a time
    (each token's answer depends on its own row alone), so that the gathered
    fp32 context, [rows, capacity, nkv, d], stays small at wide heads."""
    import torch

    return torch.cat([pa.paged_attention_reference(q[i:i + rows], k, v, tb, si[i:i + rows],
                                                   po[i:i + rows], bs)
                      for i in range(0, q.shape[0], rows)])


def queued_ms(fn, iters=20, spin_cycles=100_000_000):
    """Device time per call of ``fn`` with the host queued ahead: a
    device-side wait of ``spin_cycles`` clocks (~60 ms) holds the stream
    while the host enqueues every call, so the CUDA events between the calls
    see no launch gap, only the device work (no profiler session, which
    would cost later profiles in the same process their events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def phase_kernels():
    """Returns {kernel name: measurement dict} at the main-path shapes with
    bf16 pools, each holding the int8 pools' measurements under "int8"."""
    from functools import partial

    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa

    failures = []
    worst = {k: 0.0 for k in KERNELS}
    worst_frac = [0.0]
    built = pa.kernel_build()
    paged = ("paged_decode_kernel", "decode_merge_kernel", "paged_prefill_kernel")
    _log_ptxas(built.ptxas, tag="[kernels]", keep=paged)
    # every instantiation keeps its accumulators in registers (the d 256
    # prefill splits its output dims over two warps a row block for that)
    spills = {k: v for k, v in _ptxas_entries(built.ptxas, paged).items() if v[1] or v[2]}
    if spills:
        failures.append(f"paged kernels spill (registers, store and load bytes): {spills}")
    sm, psm = built.lib.ds_paged_smem_bytes, built.lib.ds_paged_prefill_smem_bytes
    log("[kernels] dynamic shared memory per CTA (bf16 / int8 pools), decode; prefill: "
        + "; ".join(f"d {d} {sm(d, 0)} / {sm(d, 1)} B; {psm(d, 0)} / {psm(d, 1)} B"
                    for d in pa.KERNEL_HEAD_DIMS))

    def check(tag, out, ref):
        e, frac = _err(out, ref)
        worst_frac[0] = max(worst_frac[0], frac)
        if not frac <= 1.0:
            failures.append(f"{tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")
        return e

    def check_split(tag, q, k, v, tb, si, po, bs, kw, splits):
        """The split decode's two kernels apart: the partials against their
        plain version, the merge kernel on them against the plain merge.
        Returns (partials, max error, their error fraction, the merge's
        max error)."""
        parts = pa.paged_decode_partials(q, k, v, tb, si, po, bs, splits, **kw)
        merged = pa.paged_decode_merge(*parts)
        torch.cuda.synchronize()
        ref = pa.paged_decode_partials_reference(q, k, v, tb, si, po, bs, splits, **kw)
        e, frac = _partials_err(parts, ref, _vmax(v, kw))
        worst_frac[0] = max(worst_frac[0], frac)
        if not frac <= 1.0:
            failures.append(f"paged_decode partials {tag} splits={splits}: max_abs_err {e:.3e}, "
                            f"{frac:.2f}x their tolerance")
        e_merge = check(f"paged_decode_merge {tag} splits={splits}", merged,
                        pa.merge_decode_splits(*parts))
        return parts, e, frac, e_merge

    def run_paths(tag, q, k, v, tb, si, po, bs, kw, splits):
        ref = pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw)
        outs = {"paged_decode": pa.paged_decode(q, k, v, tb, si, po, bs, kv_splits=1, **kw),
                "paged_decode_split": pa.paged_decode(q, k, v, tb, si, po, bs, kv_splits=splits,
                                                      **kw),
                "paged_prefill": pa.paged_prefill(q, k, v, tb, si, po, bs, **kw)}
        torch.cuda.synchronize()
        for name, out in outs.items():
            worst[name] = max(worst[name], check(f"{name} {tag}", out, ref))
        # the partials at this split count and at 8, more splits than blocks
        for ks in (splits, 8):
            e_merge = check_split(tag, q, k, v, tb, si, po, bs, kw, ks)[3]
            worst["paged_decode_merge"] = max(worst["paged_decode_merge"], e_merge)
        return ref

    # small sizes: a mixed prefill + decode batch with the pad run, at both
    # head dims, bf16 and int8, plain / window / ALiBi / window x ALiBi
    g_small = torch.Generator().manual_seed(0)
    for d in (128, 64):
        for int8 in (False, True):
            for window, alibi in ((None, False), (17, False), (None, True), (17, True)):
                nkv, g, bs = 2, 4, 16
                tables = torch.randperm(12, generator=g_small).to(torch.int32).reshape(3, 4)
                seq = torch.tensor([0] * 13 + [1] * 6 + [2] + [0] * 3, dtype=torch.int32)
                pos = torch.tensor(list(range(20, 33)) + list(range(16, 22)) + [53, 0, 0, 0],
                                   dtype=torch.int32)
                q, k, v, tb, si, po, kw = _make_case(d + int8, nkv, g, d, bs, tables, seq, pos,
                                                     int8)
                if window:
                    kw["window"] = window
                if alibi:
                    kw["alibi"] = torch.tensor([2.0**-(i + 1) for i in range(nkv * g)],
                                               device="cuda")
                run_paths(f"d={d} int8={int8} window={window} alibi={alibi}", q, k, v, tb, si,
                          po, bs, kw, splits=3)
    # the model families' group sizes and head dims: g 1 (Bloom's MHA,
    # GPT-2, OPT; phi-2, GPT-NeoX, GPT-J) at every head dim, g 7 (Qwen2: a
    # prefill tile of 9 tokens, one masked row in 64), g 16 (Falcon-40B: a
    # tile of 4) and g 71 over one kv head (Falcon-7B: nine decode head
    # tiles, the last of 7; prefill tiles of 8 tokens in nine row chunks),
    # plain and with the model's own ALiBi slopes
    from deepspeed_tpu_torch.models.transformer import alibi_slopes

    n_family = 0
    for nkv, g, d in FAMILY_GROUP_CASES:
        for int8 in (False, True) if d in FAMILY_INT8_DIMS else (False, ):
            for alibi in (False, True):
                tables = torch.randperm(12, generator=g_small).to(torch.int32).reshape(3, 4)
                seq = torch.tensor([0] * 13 + [1] * 6 + [2] + [0] * 3, dtype=torch.int32)
                pos = torch.tensor(list(range(20, 33)) + list(range(16, 22)) + [53, 0, 0, 0],
                                   dtype=torch.int32)
                q, k, v, tb, si, po, kw = _make_case(100 * g + d + alibi + 7 * int8, nkv, g, d,
                                                     16, tables, seq, pos, int8)
                if alibi:
                    kw["alibi"] = torch.as_tensor(alibi_slopes(nkv * g), device="cuda")
                run_paths(f"g={g} nkv={nkv} d={d} int8={int8} alibi={alibi}", q, k, v, tb, si,
                          po, 16, kw, splits=3)
                n_family += 1
    n_small = 32 + n_family
    log(f"[kernels] small-size matrix ({n_small} cases x 3 paths: g 4 at d 128 / 64, bf16 / "
        f"int8, plain / window / ALiBi / both; (nkv, g, d) {list(FAMILY_GROUP_CASES)} plain / "
        f"ALiBi, int8 too at d {FAMILY_INT8_DIMS}; the split's partials and merge at 3 and 8 "
        f"splits): {'all within tolerance' if not failures else failures}; max_abs_err {worst}")

    # main-path shapes: Mistral-7B attention (GQA 32/8, d 128), block 64,
    # tables of 32 blocks (max_context 2048), sliding window 4096
    nkv, g, d, bs, mb, S, ctx, T_pre = 8, 4, 128, 64, 32, 32, 1024, 512
    nq = nkv * g
    tables = torch.randperm(S * mb, generator=g_small).to(torch.int32).reshape(S, mb)
    res = {}
    device_jobs = []  # (measurement dict, its key, call)
    for int8 in (False, True):
        kvb = 1 if int8 else 2
        scale_b = 8 if int8 else 0  # k and v fp32 scale per (slot, head)
        # decode: 32 sequences, one token each at position 1023
        q, k, v, tb, si, po, kw = _make_case(7 + int8, nkv, g, d, bs, tables,
                                             torch.arange(S, dtype=torch.int32),
                                             torch.full((S, ), ctx - 1, dtype=torch.int32), int8)
        kw["window"] = 4096
        ref = pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw)
        splits = pa.resolve_kv_splits(S, S, mb)
        meas, fns = {}, {}
        for name, ks in (("paged_decode", 1), ("paged_decode_split", splits)):
            fn = fns[name] = partial(pa.paged_decode, q, k, v, tb, si, po, bs, kv_splits=ks, **kw)
            e = check(f"{name} main int8={int8}", fn(), ref)
            meas[name] = dict(err=e, ms=time_ms(fn))
        # the split route's two kernels apart, each checked
        parts, _, frac_p, e_merge = check_split(f"main int8={int8}", q, k, v, tb, si, po, bs, kw,
                                                splits)
        kernel_fn = partial(pa.paged_decode_partials, q, k, v, tb, si, po, bs, splits, **kw)
        merge_fn = partial(pa.paged_decode_merge, *parts)
        meas["paged_decode_split"].update(kernel_ms=time_ms(kernel_fn), merge_ms=time_ms(merge_fn),
                                          partials_error_fraction=frac_p)
        merge_plain = time_ms(lambda: pa.merge_decode_splits(*parts), iters=20, warmup=2)
        merge_bytes = splits * S * nq * (d + 2) * 4 + S * nq * d * 2
        m_ms, m_by = bound_ms(merge_bytes, 3 * splits * S * nq * d, FP32_FLOPS_PER_S)
        plain = time_ms(lambda: pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw),
                        iters=10, warmup=2)
        n_bytes = (S * nq * d * 2 * 2 + S * ctx * nkv * (2 * d * kvb + scale_b)
                   + tb.numel() * 4 + 2 * S * 4)
        flops = 4 * nq * d * S * ctx
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_ms = None
        if not int8:
            slots = (tb.long()[:, :ctx // bs, None] * bs
                     + torch.arange(bs, device="cuda")).reshape(S, ctx)
            kc = k[slots].permute(0, 2, 1, 3).contiguous()  # [S, nkv, ctx, d]
            vc = v[slots].permute(0, 2, 1, 3).contiguous()
            qc = q[:, :, None, :]  # [S, nq, 1, d]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True))
        for name, m in meas.items():
            res[(name, int8)] = dict(m, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                                     library_ms=lib_ms)
            device_jobs.append((res[(name, int8)], "device_ms", fns[name]))
        res[("paged_decode_merge", int8)] = dict(
            err=e_merge, ms=meas["paged_decode_split"]["merge_ms"], plain_ms=merge_plain,
            bound_ms=m_ms, bound_by=m_by, library_ms=None, splits=splits)
        device_jobs.append((res[("paged_decode_merge", int8)], "device_ms", merge_fn))
        device_jobs.append((res[("paged_decode_split", int8)], "kernel_device_ms", kernel_fn))
        sp = meas["paged_decode_split"]
        log(f"[kernels] decode S={S} ctx={ctx} int8={int8} splits={splits}: "
            f"paged_decode {meas['paged_decode']['ms']:.4f} ms, paged_decode_split "
            f"{sp['ms']:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}), sdpa on gathered context {lib_ms} ms, max_abs_err "
            f"{meas['paged_decode']['err']:.3e} / {sp['err']:.3e}")
        log(f"[kernels] decode split route apart, int8={int8}: split kernel {sp['kernel_ms']:.4f} "
            f"ms, merge kernel {sp['merge_ms']:.4f} ms (bound {m_ms:.5f} ms ({m_by}), plain merge "
            f"{merge_plain:.4f} ms); partials {frac_p:.3f} of their tolerance, merge max_abs_err "
            f"{e_merge:.3e}")

        # prefill: one 512-token chunk of one sequence from position 0
        q, k, v, tb, si, po, kw = _make_case(11 + int8, nkv, g, d, bs, tables[:1],
                                             torch.zeros(T_pre, dtype=torch.int32),
                                             torch.arange(T_pre, dtype=torch.int32), int8)
        kw["window"] = 4096
        ref = pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw)
        # the wrapper as the serving forward's layers after the first call
        # it: the tile descriptors of these seq_idx / pos already computed
        fn = partial(pa.paged_prefill, q, k, v, tb, si, po, bs, **kw)
        e = check(f"paged_prefill main int8={int8}", fn(), ref)
        ms = time_ms(fn)
        qt = pa.prefill_q_tile(g)
        desc_ms = time_ms(lambda: pa.prefill_tiles(si, po, qt, 1))  # what the first layer adds
        plain = time_ms(lambda: pa.paged_attention_reference(q, k, v, tb, si, po, bs, **kw),
                        iters=10, warmup=2)
        n_bytes = 2 * T_pre * nq * d * 2 + T_pre * nkv * (2 * d * kvb + scale_b) + 2 * T_pre * 4
        flops = 4 * nq * d * (T_pre * (T_pre + 1) // 2)
        b_ms, b_by = bound_ms(n_bytes, flops)
        lib_ms = None
        if not int8:
            slots = (tb.long()[0, :T_pre // bs, None] * bs
                     + torch.arange(bs, device="cuda")).reshape(T_pre)
            kc = k[slots].permute(1, 0, 2)[None].contiguous()  # [1, nkv, T, d]
            vc = v[slots].permute(1, 0, 2)[None].contiguous()
            qc = q.permute(1, 0, 2)[None].contiguous()  # [1, nq, T, d]
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                    enable_gqa=True))
            # the same attention through the contiguous flash forward (no
            # block table, no paging): what the gather costs
            fk, fv = (x.transpose(1, 2).contiguous() for x in (kc, vc))  # [1, T, nkv, d]
            flash_ms = time_ms(partial(fa.flash_fwd, q[None], fk, fv, True, 4096))
        res[("paged_prefill", int8)] = dict(err=e, ms=ms, plain_ms=plain, bound_ms=b_ms,
                                            bound_by=b_by, library_ms=lib_ms,
                                            descriptors_ms=desc_ms)
        if not int8:
            res[("paged_prefill", int8)]["flash_fwd_same_work_ms"] = flash_ms
        device_jobs.append((res[("paged_prefill", int8)], "device_ms", fn))
        log(f"[kernels] prefill T={T_pre} int8={int8} q_tile={qt}: paged_prefill {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s; the tile descriptors a first call adds "
            f"{desc_ms:.4f} ms), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), sdpa on "
            f"gathered context {lib_ms} ms, the contiguous flash forward on it "
            f"{None if int8 else round(flash_ms, 4)} ms, max_abs_err {e:.3e}")
    # the six presets' head shapes at the same sizes (bf16 pools, no window):
    # each route checked once against the plain version, then timed beside
    # its byte bound and SDPA on the same context pre-gathered contiguous
    family_shapes = {name: {} for name in ("paged_decode", "paged_decode_split", "paged_prefill")}
    for preset, nq_f, nkv_f, d_f in FAMILY_SHAPES:
        g_f = nq_f // nkv_f
        q, k, v, tb, si, po, kw = _make_case(13, nkv_f, g_f, d_f, bs, tables,
                                             torch.arange(S, dtype=torch.int32),
                                             torch.full((S, ), ctx - 1, dtype=torch.int32), False)
        ref = _reference_in_chunks(pa, q, k, v, tb, si, po, bs)
        splits = pa.resolve_kv_splits(S, S, mb)
        n_bytes = (S * nq_f * d_f * 2 * 2 + S * ctx * nkv_f * 2 * d_f * 2 + tb.numel() * 4
                   + 2 * S * 4)
        b_ms, b_by = bound_ms(n_bytes, 4 * nq_f * d_f * S * ctx)
        slots = (tb.long()[:, :ctx // bs, None] * bs
                 + torch.arange(bs, device="cuda")).reshape(S, ctx)
        kc, vc = (x[slots].permute(0, 2, 1, 3).contiguous() for x in (k, v))  # [S, nkv, ctx, d]
        qc = q[:, :, None, :]  # [S, nq, 1, d]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True))
        del kc, vc
        for name, ks in (("paged_decode", 1), ("paged_decode_split", splits)):
            fn = partial(pa.paged_decode, q, k, v, tb, si, po, bs, kv_splits=ks)
            e = check(f"{name} {preset} S={S} ctx={ctx}", fn(), ref)
            family_shapes[name][preset] = dict(ms=time_ms(fn), device_ms=queued_ms(fn),
                                               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                                               err=e, head_tiles=pa.decode_head_tiles(g_f))
        del q, k, v, ref
        # prefill: one 512-token chunk of one sequence from position 0
        q, k, v, tb1, si, po, kw = _make_case(17, nkv_f, g_f, d_f, bs, tables[:1],
                                              torch.zeros(T_pre, dtype=torch.int32),
                                              torch.arange(T_pre, dtype=torch.int32), False)
        ref = _reference_in_chunks(pa, q, k, v, tb1, si, po, bs)
        fn = partial(pa.paged_prefill, q, k, v, tb1, si, po, bs)
        e = check(f"paged_prefill {preset} T={T_pre}", fn(), ref)
        n_bytes = 2 * T_pre * nq_f * d_f * 2 + T_pre * nkv_f * 2 * d_f * 2 + 2 * T_pre * 4
        pb_ms, pb_by = bound_ms(n_bytes, 4 * nq_f * d_f * (T_pre * (T_pre + 1) // 2))
        slots = (tb1.long()[0, :T_pre // bs, None] * bs
                 + torch.arange(bs, device="cuda")).reshape(T_pre)
        kc, vc = (x[slots].permute(1, 0, 2)[None].contiguous() for x in (k, v))  # [1, nkv, T, d]
        qc = q.permute(1, 0, 2)[None].contiguous()  # [1, nq, T, d]
        qt = pa.prefill_q_tile(g_f)
        family_shapes["paged_prefill"][preset] = dict(
            ms=time_ms(fn), device_ms=queued_ms(fn), bound_ms=pb_ms, bound_by=pb_by, err=e,
            q_tile=qt,
            row_chunks=pa.prefill_row_chunks(g_f, qt),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                                                      enable_gqa=True)))
        del q, k, v, ref, kc, vc, qc
        dec, spl, pre = (family_shapes[n][preset]
                         for n in ("paged_decode", "paged_decode_split", "paged_prefill"))
        log(f"[kernels] {preset} (nq {nq_f}, nkv {nkv_f}, g {g_f}, d {d_f}): decode S={S} "
            f"ctx={ctx}: paged_decode {dec['ms']:.4f} ms ({dec['device_ms']:.4f} host queued "
            f"ahead), paged_decode_split (splits={splits}) {spl['ms']:.4f} ms "
            f"({spl['device_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}), sdpa on gathered context "
            f"{lib_ms:.4f} ms, {dec['head_tiles']} head tile(s); prefill T={T_pre} q_tile={qt} "
            f"({pre['row_chunks']} row chunk(s)): paged_prefill {pre['ms']:.4f} ms "
            f"({pre['device_ms']:.4f}), bound {pb_ms:.5f} ms ({pb_by}), sdpa "
            f"{pre['library_ms']:.4f} ms; max_abs_err {dec['err']:.3e} / {spl['err']:.3e} / "
            f"{pre['err']:.3e}")
    # each path's device time with the host queued ahead (the split
    # decode's includes its merge kernel), after every timing above
    for m, key, fn in device_jobs:
        m[key] = queued_ms(fn)
    log("[kernels] device time per call with the host queued ahead (no launch gaps), bf16 / "
        "int8 pools: " + "; ".join(
            f"{name} {res[(name, False)]['device_ms']:.4f} / "
            f"{res[(name, True)]['device_ms']:.4f} ms" for name in KERNELS)
        + "; the split kernel alone " + " / ".join(
            f"{res[('paged_decode_split', i8)]['kernel_device_ms']:.4f}" for i8 in (False, True))
        + " ms")
    log(f"[kernels] largest error over all cases: {worst_frac[0]:.3f} of its tolerance "
        f"({TOL_ULPS} bf16 ulp + 2^-14); worst_error_fraction={worst_frac[0]:.6g}")
    if failures:
        raise RuntimeError("kernels disagree with the plain version: " + "; ".join(failures))
    for name, shapes in family_shapes.items():
        res[(name, False)]["family_shapes"] = shapes
    for name in KERNELS:
        res[(name, False)]["int8"] = res[(name, True)]
        res[(name, False)]["err"] = max(res[(name, False)]["err"], res[(name, True)]["err"],
                                        worst[name])
    return {name: res[(name, False)] for name in KERNELS}


# ---------------------------------------------------------------------------
# phase 4: Mistral-7B served end to end
# ---------------------------------------------------------------------------

def _serve_waves(engine, rng, tag):
    """The serving main path's traffic through ``DynamicSplitFuseScheduler``,
    counted: the launch counts set to 0 just before and read just after.
    Wave A, a 20-token prompt admitted alone (the per-token decode grid),
    then its decode horizons (the split-K grid on 32-block tables); wave B,
    a 512-token prompt and three more in one SplitFuse batch (the q-tiled
    prefill), then decode. Fails unless every request gets all its tokens
    in the vocabulary and every paged route launched. Returns (the
    launches, wave B's prompts and lengths)."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler
    from deepspeed_tpu_torch.ops import paged_attention as pa

    vocab = engine.model_config.vocab_size
    wave_a = {0: (rng.integers(0, vocab, 20), 24)}
    wave_b = {1: (rng.integers(0, vocab, 512), 32), 2: (rng.integers(0, vocab, 128), 32),
              3: (rng.integers(0, vocab, 100), 16), 4: (rng.integers(0, vocab, 200), 24)}
    sched = DynamicSplitFuseScheduler(engine)
    ttft, submitted = {}, {}
    decode_tokens, decode_s = 0, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t_start = time.perf_counter()
    for wave in (wave_a, wave_b):
        for uid, (prompt, n_new) in wave.items():
            sched.submit(uid, prompt.astype(np.int32), max_new_tokens=n_new)
            submitted[uid] = time.perf_counter()
        while sched.has_work:
            fed = sched.stats["prefill_tokens_fed"]
            before = sum(len(v) for v in sched.results.values())
            ts = time.perf_counter()
            if sched.step() == 0:
                raise RuntimeError("scheduler stalled")
            now = time.perf_counter()
            res = sched.results
            if sched.stats["prefill_tokens_fed"] == fed:  # a decode-only step
                decode_s += now - ts
                decode_tokens += sum(len(v) for v in res.values()) - before
            for uid, toks in res.items():
                if toks and uid not in ttft:
                    ttft[uid] = now - submitted[uid]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = dict(pa.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    results = sched.results
    expected = {u: n for w in (wave_a, wave_b) for u, (_, n) in w.items()}
    for uid, n in expected.items():
        toks = results.get(uid)
        if toks is None or len(toks) != n or not all(0 <= t < vocab for t in toks):
            raise RuntimeError(f"{tag} request {uid}: bad generation {toks}")
    n_tok = sum(len(v) for v in results.values())
    log(f"{tag} served {len(results)} requests, {n_tok} tokens generated in {wall:.2f}s; "
        f"TTFT p50 {1e3 * float(np.median(list(ttft.values()))):.1f} ms "
        f"(per request ms: { {u: round(1e3 * t, 1) for u, t in sorted(ttft.items())} }); "
        f"decode {decode_tokens / max(decode_s, 1e-9):.1f} tok/s over {decode_tokens} tokens; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"{tag} kernel launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"{tag} kernel paths never launched on the main path: {missing}")
    record = {"ttft_p50_ms": 1e3 * float(np.median(list(ttft.values()))),
              "decode_tok_s": decode_tokens / max(decode_s, 1e-9), "peak_gib": peak / 2**30,
              "wall_s": wall}
    return launches, wave_b, record


def _plain_route_rel(engine, prompt, tag):
    """One prefill's last-token logits, the kernels against the plain
    attention asked for explicitly on a second engine sharing the weights:
    finite, of the vocabulary's width, and within ``LOGITS_REL_L2_TOL``
    (relative L2; bf16 activations round differently after attention
    outputs that differ in the last bf16 bit, through every layer).
    Returns the relative L2."""
    import numpy as np

    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, InferenceEngineV2,
                                                  ModulesConfig, RaggedInferenceEngineConfig)

    vocab, layers = engine.model_config.vocab_size, engine.model_config.num_layers
    logits_k = engine.put([100], [prompt])
    engine.flush(100)
    dense_cfg = RaggedInferenceEngineConfig(
        kv_block_size=64, num_kv_blocks=40, state_manager=DSStateManagerConfig(max_context=2048),
        modules=ModulesConfig(attention="dense_blocked_attention"))
    dense = InferenceEngineV2(engine.module, dense_cfg, params=engine.params,
                              device=engine.device)
    logits_d = dense.put([100], [prompt])
    del dense
    if logits_k.shape != (1, vocab) or not np.isfinite(logits_k).all():
        raise RuntimeError(f"{tag} bad logits: shape {logits_k.shape}")
    rel = float(np.linalg.norm(logits_k - logits_d) / np.linalg.norm(logits_d))
    same_top = int(np.argmax(logits_k)) == int(np.argmax(logits_d))
    log(f"{tag} {len(prompt)}-token prefill logits, kernels vs dense_blocked_attention: rel L2 "
        f"{rel:.3e} (tolerance {LOGITS_REL_L2_TOL}, {layers} layers); same argmax: {same_top}")
    if not rel <= LOGITS_REL_L2_TOL:
        raise RuntimeError(f"{tag} logits disagree: rel L2 {rel:.3e} > {LOGITS_REL_L2_TOL}")
    return rel


def phase_e2e():
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig,
                                                  RaggedInferenceEngineConfig, build_model_engine)

    t0 = time.perf_counter()
    cfg = RaggedInferenceEngineConfig(kv_block_size=64,
                                      state_manager=DSStateManagerConfig(max_context=2048))
    engine = build_model_engine("mistral", "7b", cfg, seed=0)
    torch.cuda.synchronize()
    mc = engine.model_config
    n_params = engine.module.num_params()
    kv = engine.state_manager.kv_cache
    log(f"[e2e] Mistral-7B: {mc.num_layers} layers, hidden {mc.hidden_size}, heads "
        f"{mc.num_heads}/{mc.num_kv_heads}, {n_params / 1e9:.3f}B params, KV pool "
        f"{engine.num_kv_blocks} x {cfg.kv_block_size} slots ({kv.memory_bytes() / 2**30:.1f} GiB, "
        f"{kv.k_flat.numel():,} elements per pool), built in {time.perf_counter() - t0:.1f}s")
    if kv.k_flat.numel() <= 2**31:
        log("[e2e] note: the pool is below 2^31 elements; 64-bit offsets not exercised")

    rng = np.random.default_rng(0)
    launches, wave_b, _ = _serve_waves(engine, rng, "[e2e]")

    _plain_route_rel(engine, wave_b[1][0].astype(np.int32), "[e2e]")
    profile_decode(engine, rng)
    profile_prefill(engine, rng)
    return launches


def profile_decode(engine, rng, n_seqs=8, steps=4, repeats=5, tag="[e2e]"):
    """Where a decode step's time goes: torch.profiler over one warmed
    ``decode`` horizon of ``n_seqs`` sequences, kernel time summed from the
    device activity records, against the host's wall clock (the median of
    ``repeats`` unprofiled horizons: the host's clock varies from horizon to
    horizon on a machine whose CPU cores are shared). Returns (wall,
    device) ms per step."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    uids = list(range(200, 200 + n_seqs))
    prompts = [rng.integers(0, engine.model_config.vocab_size, 90).astype(np.int32)
               for _ in uids]
    first = engine.put(uids, prompts, sample="greedy")
    toks = engine.decode(uids, [[t] for t in first], 2)  # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        toks = engine.decode(uids, [[t] for t in toks[:, -1]], steps)
        walls.append(time.perf_counter() - t0)
    wall_plain = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode(uids, [[t] for t in toks[:, -1]], steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for u in uids:
        engine.flush(u)
    by_name, n_ops, n_kernels = {}, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_ops += 1
            n_kernels += not e.name.startswith(("Memcpy", "Memset"))
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"{tag} decode profile, {n_seqs} sequences x {steps} steps: wall {1e3 * wall_plain / steps:.2f} "
        f"ms/step unprofiled (median of {repeats} horizons; range "
        f"{1e3 * min(walls) / steps:.2f}-{1e3 * max(walls) / steps:.2f}), "
        f"{1e3 * wall / steps:.2f} ms/step profiled; device busy "
        f"{1e3 * busy / steps:.2f} ms/step: device idle {100 * (1 - busy / wall_plain):.1f}% of "
        f"the unprofiled wall, {100 * (1 - busy / wall):.1f}% of the profiled one; device "
        f"kernels {n_kernels / steps:.1f} per step ({n_ops / steps:.1f} with copies)")
    attn = sum(us for n, us in by_name.items() if "paged_" in n or "decode_merge" in n) / 1e6
    log(f"{tag} decode profile: paged attention kernels {1e3 * attn / steps:.3f} ms/step "
        f"({100 * attn / busy:.1f}% of device time)")
    for name, us in top:
        log(f"{tag}   {us / steps / 1e3:8.3f} ms/step  {name[:90]}")
    return 1e3 * wall_plain / steps, 1e3 * busy / steps


def profile_prefill(engine, rng, n_tok=512, repeats=5):
    """Where a prompt's time to first token goes: torch.profiler over one
    warmed ``put`` of a fresh ``n_tok``-token prompt (the prefill forward
    through all layers and its last-token logits), device time by kernel,
    against the host's wall clock (the median of ``repeats`` unprofiled
    puts)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    uid, vocab = 300, engine.model_config.vocab_size

    def put():
        prompt = rng.integers(0, vocab, n_tok).astype(np.int32)
        t0 = time.perf_counter()
        engine.put([uid], [prompt])  # returns host logits: the wall ends synchronised
        dt = time.perf_counter() - t0
        engine.flush(uid)
        return dt

    put()  # warm
    walls = [put() for _ in range(repeats)]
    wall_plain = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = put()
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    attn = sum(ms for n, ms in by_name.items() if "paged_" in n)
    log(f"[e2e] prefill profile, one {n_tok}-token put: wall {1e3 * wall_plain:.2f} ms "
        f"unprofiled (median of {repeats}; range {1e3 * min(walls):.2f}-{1e3 * max(walls):.2f}), "
        f"{1e3 * wall:.2f} ms profiled; device busy {busy:.2f} ms: device idle "
        f"{100 * (1 - busy / (1e3 * wall_plain)):.1f}% of the unprofiled wall; paged attention "
        f"kernels {attn:.3f} ms ({100 * attn / busy:.1f}% of device time)")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[e2e]   {ms:8.3f} ms  {name[:90]}")
    # the same puts with the prefill's tile descriptors computed in every
    # layer (the wrapper's memo bypassed here, then restored)
    from deepspeed_tpu_torch.ops import paged_attention as pa

    memo = pa.cached_prefill_tiles
    pa.cached_prefill_tiles = pa.prefill_tiles
    try:
        walls_nomemo = [put() for _ in range(repeats)]
    finally:
        pa.cached_prefill_tiles = memo
    log(f"[e2e] the same put with the tile descriptors computed in every layer: wall "
        f"{1e3 * float(np.median(walls_nomemo)):.2f} ms (median of {repeats}; range "
        f"{1e3 * min(walls_nomemo):.2f}-{1e3 * max(walls_nomemo):.2f})")


# ---------------------------------------------------------------------------
# phase 3: the training kernels against their plain versions
# ---------------------------------------------------------------------------

def _flash_err(out, ref, lse=False):
    """(max |out - ref|, the largest error as a fraction of its element's
    tolerance) for the flash attention outputs (see the module docstring);
    a NaN counts as an infinite error."""
    import torch

    ref = ref.float()
    err = (out.float() - ref).abs()
    err = torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)
    if lse:
        tol = 2.0**-14 * (1.0 + ref.abs())
    else:
        floor = max(TOL_FLOOR, GRAD_FLOOR_RMS * float(ref.pow(2).mean().sqrt()))
        tol = TOL_ULPS * bf16_ulp(ref) + floor
    return float(err.max()), float((err / tol).max())


def _flash_case(seed, B, S, nq, nkv, d, dtype=None):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtype = dtype or torch.bfloat16
    mk = lambda n: torch.randn(B, S, n, d, generator=gen, device="cuda").to(dtype)
    return mk(nq), mk(nkv), mk(nkv), mk(nq)  # q, k, v, dout


def _flash_all(fa, q, k, v, do, causal, window, slopes):
    """Kernels: (out, lse, dq, dk, dv); the backward on the forward's own
    out and lse, in the autograd Function's order: dq first, handing its
    delta to dk/dv."""
    out, lse = fa.flash_fwd(q, k, v, causal, window, slopes)
    dq, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, causal, window, slopes)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, lse, delta, do, causal, window, slopes)
    return out, lse, dq, dk, dv


def _causal_pairs(S, window):
    """(query, key) pairs a causal window of ``window`` keys leaves visible."""
    return sum(min(i + 1, window) for i in range(S))


def _flash_spec(B, S, nq, nkv, d, pairs, el=2):
    """{kernel: (bytes it must move, FLOPs it must do)} of the three flash
    kernels at (B, S, nq, nkv, d) with ``pairs`` visible (query, key) pairs
    per head. dq reads q, k, v, out, dout, lse and writes dq and delta;
    dk/dv reads q, k, v, dout, lse, delta and writes dk, dv. FLOPs: the
    products the function needs (2 d per pair each: q.k, dO.v and ds.k; dk/dv
    q.k, dO.v, p^T.dO, ds^T.q), not the split pairs or the d 256 kernels'
    repeated score products."""
    io_q = B * S * nq * d * el  # q, out, dout, dq: each this size
    io_kv = B * S * nkv * d * el  # k, v, dk, dv
    lse_b = B * nq * S * 4  # lse, delta: each this size
    return {"flash_fwd": (io_q + 2 * io_kv + io_q + lse_b, 4 * B * nq * d * pairs),
            "flash_bwd_dkdv": (2 * io_q + 2 * io_kv + 2 * lse_b + 2 * io_kv,
                               4 * 2 * B * nq * d * pairs),
            "flash_bwd_dq": (3 * io_q + 2 * io_kv + lse_b + io_q + lse_b,
                             3 * 2 * B * nq * d * pairs)}


def _sdpa_ms(q, k, v, do):
    """SDPA on the flash kernels' [B, S, n, d] inputs as [B, n, S, d] (kv
    heads repeated to nq), causal: (forward ms, its autograd backward ms)."""
    import torch
    import torch.nn.functional as F

    g = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.repeat_interleave(g, dim=2).transpose(1, 2).contiguous().requires_grad_()
    vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous().requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), iters=10,
                  warmup=2)
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bwd = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), iters=10,
                  warmup=2)
    return fwd, bwd


def _flash_times(fa, q, k, v, do, out, lse, window, iters=10):
    """Each flash kernel's ms (CUDA events over warmed launches), causal."""
    delta = fa.flash_delta(out, do)
    return {"flash_fwd": time_ms(lambda: fa.flash_fwd(q, k, v, True, window, None), iters=iters,
                                 warmup=2),
            "flash_bwd_dkdv": time_ms(
                lambda: fa.flash_bwd_dkdv(q, k, v, lse, delta, do, True, window), iters=iters,
                warmup=2),
            "flash_bwd_dq": time_ms(lambda: fa.flash_bwd_dq(q, k, v, out, lse, do, True, window),
                                    iters=iters, warmup=2)}


def phase_train_kernels():
    """Returns {kernel name: measurement dict} for the four training kernels
    (the flash kernels' also hold ``family_shapes``)."""
    import torch

    from deepspeed_tpu_torch.models.transformer import alibi_slopes
    from deepspeed_tpu_torch.ops import flash_attention as fa

    failures, ptxas_failures = [], []
    worst = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    worst_frac = [0.0, ""]
    owner = {"out": "flash_fwd", "lse": "flash_fwd", "dq": "flash_bwd_dq",
             "dk": "flash_bwd_dkdv", "dv": "flash_bwd_dkdv"}

    # every instantiation (5 head dims x bf16 / fp16 x 3 kernels) keeps its
    # accumulators in registers: any spilled byte fails the phase
    flash = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkdv_kernel")
    built = fa.kernel_build()
    _log_ptxas(built.ptxas, tag="[train_kernels]", keep=flash)
    entries = _ptxas_entries(built.ptxas, flash)
    spills = {k: v for k, v in entries.items() if v[1] or v[2]}
    log(f"[train_kernels] flash ptxas: {len(entries)} instantiations, registers "
        f"{sorted({v[0] for v in entries.values()})}, {len(spills)} spilling")
    if len(entries) != 3 * 2 * len(fa.KERNEL_HEAD_DIMS):
        ptxas_failures.append(f"{len(entries)} flash instantiations in the ptxas report, not "
                              f"{3 * 2 * len(fa.KERNEL_HEAD_DIMS)}")
    if spills:
        ptxas_failures.append(f"flash kernels spill (registers, store and load bytes): {spills}")
    fsm = built.lib.ds_flash_smem_bytes
    log("[train_kernels] flash dynamic shared memory per CTA (forward / dk/dv / dq): "
        + "; ".join(f"d {d} {fsm(0, d)} / {fsm(1, d)} / {fsm(2, d)} B"
                    for d in fa.KERNEL_HEAD_DIMS))

    def check_flash(tag, got, causal, window, slopes, q, k, v, do):
        r_out, r_lse = fa.flash_attention_reference(q, k, v, causal, window, slopes)
        r_dq, r_dk, r_dv = fa.flash_attention_reference_bwd(q, k, v, got[0], got[1], do, causal,
                                                            window, slopes)
        torch.cuda.synchronize()
        errs = {}
        for name, a, r in zip(("out", "lse", "dq", "dk", "dv"), got,
                              (r_out, r_lse, r_dq, r_dk, r_dv)):
            e, frac = _flash_err(a, r, lse=name == "lse")
            errs[name] = e
            if frac > worst_frac[0]:
                worst_frac[:] = [frac, f"{name} {tag}"]
            if name != "lse":
                worst[owner[name]] = max(worst[owner[name]], e)
            if not frac <= 1.0:
                failures.append(f"{name} {tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")
        return errs

    # small sizes: ragged S, every head dim, GQA groups 1 and 4, causal and
    # not, a window, ALiBi with power-of-two and other head counts
    n_cases = 0
    for S in (1, 100, 128, 257):
        for d in fa.KERNEL_HEAD_DIMS:
            for nq, nkv, pow2 in ((4, 4, True), (8, 2, True), (6, 6, False), (12, 3, False)):
                modes = ([(False, None, False), (True, None, False), (True, 48, False),
                          (True, None, True), (False, None, True)] if pow2 else
                         [(True, 48, False), (True, None, True), (True, 48, True)])
                for causal, window, alibi in modes:
                    q, k, v, do = _flash_case(S * 7 + d + nq, 2, S, nq, nkv, d)
                    slopes = (torch.as_tensor(alibi_slopes(nq), device="cuda") if alibi
                              else None)
                    got = _flash_all(fa, q, k, v, do, causal, window, slopes)
                    check_flash(f"S={S} d={d} heads={nq}/{nkv} causal={causal} window={window} "
                                f"alibi={alibi}", got, causal, window, slopes, q, k, v, do)
                    n_cases += 1
    # float16 inputs (an fp16 ds_config's compute dtype): the kernels' other
    # instantiation at every head dim, held to the same (bf16-ulp) tolerance
    for S in (100, 257):
        for d in fa.KERNEL_HEAD_DIMS:
            q, k, v, do = _flash_case(S + d, 2, S, 8, 2, d, torch.float16)
            got = _flash_all(fa, q, k, v, do, True, 48, None)
            check_flash(f"fp16 S={S} d={d} heads=8/2 causal=True window=48", got, True, 48, None,
                        q, k, v, do)
            n_cases += 1
    log(f"[train_kernels] flash small-size matrix ({n_cases} cases x out, lse, dq, dk, dv): "
        f"{'all within tolerance' if not failures else failures}; max_abs_err {worst}")

    # the training shapes: Mistral-7B attention over one 4096-token sequence
    B, S, nq, nkv, d, W = 1, TRAIN_SEQ, 32, 8, 128, 4096
    q, k, v, do = _flash_case(11, B, S, nq, nkv, d)
    got = _flash_all(fa, q, k, v, do, True, W, None)
    errs = check_flash(f"main B={B} S={S} heads={nq}/{nkv} d={d} window={W}", got, True, W, None,
                       q, k, v, do)
    out, lse = got[0], got[1]
    res = {}
    ms = _flash_times(fa, q, k, v, do, out, lse, W)
    plain = {"flash_fwd": time_ms(lambda: fa.flash_attention_reference(q, k, v, True, W),
                                  iters=3, warmup=1)}
    plain["flash_bwd_dkdv"] = plain["flash_bwd_dq"] = time_ms(
        lambda: fa.flash_attention_reference_bwd(q, k, v, out, lse, do, True, W), iters=3,
        warmup=1)
    # library yardstick: SDPA forward, and its autograd backward for the two
    # backward kernels
    lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do)
    spec = _flash_spec(B, S, nq, nkv, d, _causal_pairs(S, W))
    for name, (n_bytes, flops) in spec.items():
        lib = lib_fwd if name == "flash_fwd" else lib_bwd
        b_ms, b_by = bound_ms(n_bytes, flops)
        res[name] = dict(err=worst[name], ms=ms[name], plain_ms=plain[name], bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib)
        log(f"[train_kernels] {name} B={B} S={S} heads={nq}/{nkv} d={d} causal window={W}: "
            f"{ms[name]:.3f} ms ({flops / ms[name] / 1e9:.1f} TFLOP/s), plain "
            f"{plain[name]:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP), sdpa "
            f"{'forward' if name == 'flash_fwd' else 'backward'} {lib:.4f} ms")
    log(f"[train_kernels] main-shape max_abs_err: { {k_: f'{e_:.3e}' for k_, e_ in errs.items()} }")
    del q, k, v, do, got, out, lse

    # rows 4-6 at the presets' attention shapes, causal over their
    # max_seq_len: checked against the plain version (not timed), timed
    # beside the bound and SDPA
    for name in worst:
        res[name]["family_shapes"] = {}
    Sf = FLASH_FAMILY_SEQ
    for preset, fnq, fnkv, fd in FLASH_FAMILY_SHAPES:
        q, k, v, do = _flash_case(fnq + fd, 1, Sf, fnq, fnkv, fd)
        got = _flash_all(fa, q, k, v, do, True, None, None)
        errs = check_flash(f"{preset} B=1 S={Sf} heads={fnq}/{fnkv} d={fd} causal", got, True,
                           None, None, q, k, v, do)
        ms = _flash_times(fa, q, k, v, do, got[0], got[1], None)
        lib_fwd, lib_bwd = _sdpa_ms(q, k, v, do)
        spec = _flash_spec(1, Sf, fnq, fnkv, fd, _causal_pairs(Sf, Sf))
        for name, (n_bytes, flops) in spec.items():
            lib = lib_fwd if name == "flash_fwd" else lib_bwd
            b_ms, b_by = bound_ms(n_bytes, flops)
            err = max(errs[o] for o in owner if owner[o] == name and o != "lse")
            res[name]["family_shapes"][preset] = dict(
                heads=f"{fnq}/{fnkv}", head_dim=fd, seq=Sf, ms=ms[name], bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, max_abs_err=err)
            log(f"[train_kernels] {preset} {name} B=1 S={Sf} heads={fnq}/{fnkv} d={fd} causal: "
                f"{ms[name]:.4f} ms ({flops / ms[name] / 1e9:.1f} TFLOP/s), bound {b_ms:.4f} ms "
                f"({b_by}), sdpa {'forward' if name == 'flash_fwd' else 'backward'} "
                f"{lib:.4f} ms, max_abs_err {err:.3e}")
        del q, k, v, do, got
    log(f"[train_kernels] flash: largest error over all cases {worst_frac[0]:.3f} of its "
        f"tolerance ({worst_frac[1]}); worst_error_fraction={worst_frac[0]:.6g}")
    for name in worst:
        res[name]["err"] = worst[name]
    if failures:
        raise RuntimeError("flash kernels disagree with the plain version: "
                           + "; ".join(failures[:10] + ptxas_failures))
    if ptxas_failures:
        raise RuntimeError("; ".join(ptxas_failures))
    res["fused_adam"] = _check_fused_adam()
    return res


def _adam_set(sizes, seed, unaligned=()):
    """fp32 params / moments / grads of the given sizes from a seeded
    generator; the leaves in ``unaligned`` sit one element past an aligned
    address (no 16-byte vector access)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sets = {"p": [], "m": [], "v": [], "g": []}
    for i, n in enumerate(sizes):
        off = 1 if i in unaligned else 0
        for key, fill in (("p", "randn"), ("m", "randn"), ("v", "rand"), ("g", "randn")):
            buf = getattr(torch, fill)(n + off, generator=gen, device="cuda")
            if key == "m":
                buf.mul_(1e-2)
            if key == "v":
                buf.mul_(1e-4)
            sets[key].append(buf[off:])
    return sets


def _check_fused_adam():
    import torch

    from deepspeed_tpu_torch.ops import fused_adam as fad

    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1)
    sizes = [1, 7, 127, 1000003, 14336 * 4096 + 1, 4096 * 4096 - 3, 32000 * 4096 + 5,
             33554431, 4096 * 4096]
    n = sum(sizes)
    a = _adam_set(sizes, 5, unaligned=(3, ))
    b = {k: [t.clone() for t in v] for k, v in a.items()}
    gs = torch.full((), 0.37, device="cuda")
    lr = torch.full((), 1e-4, device="cuda")
    kw = dict(lr_t=lr, step=torch.full((), 3, dtype=torch.int32, device="cuda"), grad_scale=gs,
              **hyper)
    fad.fused_adam_apply(a["p"], a["m"], a["v"], a["g"], gate=torch.ones((), device="cuda"), **kw)
    fad.fused_adam_reference(b["p"], b["m"], b["v"], b["g"], gate=1.0, **kw)
    torch.cuda.synchronize()
    err, frac = 0.0, 0.0
    for key in ("p", "m", "v"):
        for x, y in zip(a[key], b[key]):
            d = (x - y).abs()
            err = max(err, float(d.max()))
            frac = max(frac, float((d / (ADAM_RTOL * y.abs()).clamp_min(1e-30)).max()))
    n_exact = sum(int(torch.equal(x, y)) for key in ("p", "m", "v") for x, y in zip(a[key], b[key]))
    # bf16 gradients on the small leaves
    c = {k: [t.clone() for t in v[:4]] for k, v in b.items()}
    d16 = {k: [t.clone() for t in v[:4]] for k, v in b.items()}
    g16 = [t.to(torch.bfloat16) for t in c["g"]]
    fad.fused_adam_apply(c["p"], c["m"], c["v"], g16, gate=1.0, **kw)
    fad.fused_adam_reference(d16["p"], d16["m"], d16["v"], g16, gate=1.0, **kw)
    for key in ("p", "m", "v"):
        for x, y in zip(c[key], d16[key]):
            dd = (x - y).abs()
            err = max(err, float(dd.max()))
            frac = max(frac, float((dd / (ADAM_RTOL * y.abs()).clamp_min(1e-30)).max()))
    # gate 0 (an overflow step, NaN gradients): nothing is written
    before = {k: [t.clone() for t in a[k]] for k in ("p", "m", "v")}
    nan_g = [torch.full_like(t, float("nan")) for t in a["g"][:4]] + a["g"][4:]
    fad.fused_adam_apply(a["p"], a["m"], a["v"], nan_g, gate=torch.zeros((), device="cuda"),
                         **kw)
    torch.cuda.synchronize()
    gate0_ok = all(torch.equal(x, y) for k in ("p", "m", "v") for x, y in zip(a[k], before[k]))
    del before, nan_g, c, d16, g16
    log(f"[train_kernels] fused_adam on {n:,} fp32 elements in {len(sizes)} leaves (sizes "
        f"{sizes}; leaf 3 unaligned): gate 1 max_abs_err {err:.3e} ({frac:.3f} of its tolerance "
        f"{ADAM_RTOL} x |plain|; {n_exact} of {3 * len(sizes)} tensors bit-identical), bf16 grads "
        f"included; gate 0 leaves p/m/v bit-identical: {gate0_ok}")
    if not (frac <= 1.0 and gate0_ok):
        raise RuntimeError(f"fused_adam disagrees with the plain version (err {err:.3e}, "
                           f"{frac:.2f}x tolerance, gate-0 untouched: {gate0_ok})")
    one = torch.ones((), device="cuda")
    ms = time_ms(lambda: fad.fused_adam_apply(a["p"], a["m"], a["v"], a["g"], gate=one, **kw),
                 iters=20, warmup=3)
    plain = time_ms(lambda: fad.fused_adam_reference(b["p"], b["m"], b["v"], b["g"], gate=one,
                                                     **kw), iters=3, warmup=1)
    del b
    ps = [torch.nn.Parameter(t) for t in a["p"]]
    for p_, g_ in zip(ps, a["g"]):
        p_.grad = g_
    lib = torch.optim.AdamW(ps, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1,
                            fused=True)
    lib_ms = time_ms(lib.step, iters=20, warmup=3)
    del lib, ps, a
    b_ms, b_by = bound_ms(28 * n, 20 * n, FP32_FLOPS_PER_S)
    log(f"[train_kernels] fused_adam {n:,} elements: {ms:.3f} ms, plain {plain:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}: 28 B/element), torch.optim.AdamW(fused=True) {lib_ms:.3f} ms")
    return dict(err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phase: the MoE kernels (grouped matmul) against their plain versions
# ---------------------------------------------------------------------------

def _tgmm_err(out, ref, be, bt):
    """tgmm (fp32, never rounded): per expert e, |out - ref| <= 2^-16 *
    sqrt(rows summed into out[e]) * rms(ref[e]) (+ 2^-30 for an expert with
    no rows, whose plain output is exactly 0)."""
    import torch

    rows = torch.bincount(be.long(), minlength=ref.shape[0]).float() * bt
    rms = ref.pow(2).mean(dim=(1, 2)).sqrt()
    tol = (TGMM_FLOOR * rows.sqrt() * rms + 2.0**-30)[:, None, None]
    err = (out - ref).abs()
    return float(err.max()), float((err / tol).max())


def _library_grouped(kind, a, b, be, bt, E):
    """A library yardstick for the same groups: ``torch._grouped_mm`` where
    this torch has it and takes these layouts, else a loop of E
    ``torch.mm`` calls (bf16 out). Returns (name, fn)."""
    import torch

    counts = torch.bincount(be.long(), minlength=E) * bt
    ends = torch.cumsum(counts, 0).to(torch.int32)
    bounds = [0] + ends.tolist()
    grouped = getattr(torch, "_grouped_mm", None)
    cands = []
    if grouped is not None:
        if kind == "gmm":
            b_cm = b.transpose(1, 2).contiguous().transpose(1, 2)  # column-major [E, K, N]
            cands = [lambda: grouped(a, b, offs=ends), lambda: grouped(a, b_cm, offs=ends)]
        else:
            cands = [lambda: grouped(a.t(), b, offs=ends, out_dtype=torch.float32),
                     lambda: grouped(a.t().contiguous(), b, offs=ends, out_dtype=torch.float32)]
    for fn in cands:
        try:
            fn()
            torch.cuda.synchronize()
            return "torch._grouped_mm", fn
        except Exception:  # noqa: BLE001 -- a yardstick only: try the next layout
            continue
    if kind == "gmm":
        return "loop of torch.mm over the experts", lambda: [
            torch.mm(a[bounds[e]:bounds[e + 1]], b[e]) for e in range(E)]
    return "loop of torch.mm over the experts", lambda: [
        torch.mm(a[bounds[e]:bounds[e + 1]].t(), b[bounds[e]:bounds[e + 1]]) for e in range(E)]


def _gmm_sass_check(gm):
    """The grouped matmul library's SASS must hold warpgroup MMAs (HGMMA):
    count them with ``cuobjdump -sass``; raise without cuobjdump or with
    none. Also print ptxas's registers / shared memory / spills of the
    wgmma route's kernels."""
    import shutil

    built = gm.kernel_build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: the HGMMA check of the grouped matmul needs it")
    sass = subprocess.run([tool, "-sass", str(built.path)], capture_output=True, text=True,
                          timeout=300).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"[moe_kernels] cuobjdump -sass {os.path.relpath(built.path, HERE)}: {n_hgmma} HGMMA "
        f"instructions")
    import re

    name = None
    for line in built.ptxas.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"wgmma_kernelI(?:13__nv_bfloat16|6__half)Li(\d)E", line)
            kind = ("gmm", "gmm trans_b", "tgmm")[int(m.group(1))] if m else None
            name = kind and f"{kind} {'fp16' if '6__half' in line else 'bf16'}"
        elif name and ("Used" in line or "spill" in line or "warning" in line.lower()):
            log(f"[moe_kernels] ptxas, wgmma route {name}: {line.split(':', 1)[-1].strip()}")
    lib = built.lib
    log(f"[moe_kernels] wgmma route dynamic shared memory per CTA: {lib.ds_gmm_smem_bytes()} B "
        f"(3 ring stages of 48 KB, 2 x 32 KB of output staging)")
    if n_hgmma == 0:
        raise RuntimeError("the grouped matmul library holds no HGMMA instruction")
    return n_hgmma


def phase_moe_kernels():
    """Returns {kernel name: measurement dict} for gmm and tgmm."""
    import torch

    from deepspeed_tpu_torch.inference.v2.modules import (ConfigBundle, DSMoEConfig,
                                                          DSMoERegistry)
    from deepspeed_tpu_torch.moe.grouped import block_align_dispatch
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' fp32 products
    n_hgmma = _gmm_sass_check(gm)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    worst = {"gmm": [0.0, 0.0, ""], "tgmm": [0.0, 0.0, ""]}  # max err, max fraction, case

    def record(name, tag, e, frac):
        w = worst[name]
        w[0] = max(w[0], e)
        if frac > w[1]:
            w[1], w[2] = frac, tag
        if not frac <= 1.0:
            failures.append(f"{name} {tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")

    def check_all(tag, lhs, rhs, dy, be, bt, E):
        tag = f"{tag} route={gm.route(lhs.shape[1], dy.shape[1])}"
        out = gm.gmm(lhs, rhs, be, bt)
        dx = gm.gmm(dy, rhs, be, bt, trans_b=True)
        dw = gm.tgmm(lhs, dy, be, E, bt)
        refs = (gm.gmm_plain(lhs, rhs, be, bt), gm.gmm_plain(dy, rhs, be, bt, trans_b=True),
                gm.tgmm_plain(lhs, dy, be, E, bt))
        torch.cuda.synchronize()
        # gmm rounds like the flash outputs: the flash tolerance
        record("gmm", f"{tag} forward", *_flash_err(out, refs[0]))
        record("gmm", f"{tag} trans_b", *_flash_err(dx, refs[1]))
        record("tgmm", tag, *_tgmm_err(dw, refs[2], be, bt))

    # small cases: (T, K, N, E, block table, dtype, bt, zero rows)
    cases = [
        (512, 200, 136, 3, [0, 0, 1, 2], torch.bfloat16, 128, None),  # K, N off the tiles
        (512, 200, 136, 3, [0, 0, 1, 2], torch.float16, 128, None),
        (384, 37, 45, 2, [0, 1, 1], torch.bfloat16, 128, None),  # widths not multiples of 8
        (768, 96, 256, 4, [0, 0, 1, 2, 3, 3], torch.bfloat16, 128, 2),  # expert 1: padding only
        (384, 128, 128, 1, [0, 0, 0], torch.bfloat16, 128, None),  # a single expert
        (1024, 160, 200, 2, [0, 1, 1, 1], torch.float16, 256, None),  # 256-row blocks
        (256, 4096, 14336, 2, [0, 1], torch.bfloat16, 128, None),  # the main path's widths
    ]
    for T, K, N, E, be_list, dt, bt, zero_block in cases:
        be = torch.tensor(be_list, dtype=torch.int32, device=dev)
        lhs = torch.randn(T, K, generator=gen, device=dev).to(dt)
        dy = torch.randn(T, N, generator=gen, device=dev).to(dt)
        if zero_block is not None:  # the padding block of an expert with no tokens
            lhs[zero_block * bt:(zero_block + 1) * bt] = 0
            dy[zero_block * bt:(zero_block + 1) * bt] = 0
        rhs = (torch.randn(E, K, N, generator=gen, device=dev) / K**0.5).to(dt)
        check_all(f"T={T} K={K} N={N} E={E} bt={bt} {str(dt)[6:]} table={be_list}", lhs, rhs,
                  dy, be, bt, E)
    routes = {r: [f"K={K} N={N}" for _, K, N, *_ in cases if gm.route(K, N) == r]
              for r in ("wgmma", "wmma")}
    log(f"[moe_kernels] routes of the small cases (by shape alone, gm.route(K, N)): {routes}")
    log(f"[moe_kernels] small-size matrix ({len(cases)} cases x gmm, gmm trans_b, tgmm): "
        f"{'all within tolerance' if not failures else failures}; largest errors: gmm "
        f"{worst['gmm'][0]:.3e} ({worst['gmm'][1]:.3f} of tolerance), tgmm {worst['tgmm'][0]:.3e} "
        f"({worst['tgmm'][1]:.3f})")

    # the main path's shapes: Mixtral-8x7B's expert FFN over 4096 tokens,
    # top-2 routed (8192 rows), dispatched by the port's own dispatcher
    S, H, Fd, E, k, bt = 4096, 4096, 14336, 8, 2, 128
    x = torch.randn(S, H, generator=gen, device=dev).to(torch.bfloat16)
    logits = torch.randn(S, E, generator=gen, device=dev)
    top_w, top_idx = torch.softmax(logits, -1).topk(k, dim=-1)
    tok, _, dest, be, T_pad = block_align_dispatch(None, k, bt, top_idx=top_idx, top_w=top_w,
                                                   num_experts=E)
    x_sorted = x.new_zeros((T_pad, H)).index_copy(0, dest, x[tok])
    wi = (torch.randn(E, H, Fd, generator=gen, device=dev) / H**0.5).to(torch.bfloat16)
    wo = (torch.randn(E, Fd, H, generator=gen, device=dev) / Fd**0.5).to(torch.bfloat16)
    mid = torch.randn(T_pad, Fd, generator=gen, device=dev).to(torch.bfloat16)
    mid[(x_sorted == 0).all(dim=1)] = 0  # padding rows stay zero, as after the activation
    rows = S * k
    del x
    gm.reset_launch_counts()
    check_all(f"main T_pad={T_pad}", x_sorted, wi, mid, be, bt, E)
    check_all(f"main-down T_pad={T_pad}", mid, wo, x_sorted, be, bt, E)
    main_launches = dict(gm.launch_counts)
    log(f"[moe_kernels] launches at the Mixtral widths (two checks of gmm, gmm trans_b, tgmm): "
        f"{main_launches} (route {gm.route(H, Fd)} only)")
    if main_launches != {"gmm": 4, "tgmm": 2, "gmm_wmma": 0, "tgmm_wmma": 0}:
        failures.append(f"the Mixtral widths did not go only through the wgmma kernels: "
                        f"{main_launches}")
    calls = {  # name -> (kernel fn, plain fn, library kind and operands, flops, bytes)
        "gmm up (K 4096, N 14336)": (
            lambda: gm.gmm(x_sorted, wi, be, bt), lambda: gm.gmm_plain(x_sorted, wi, be, bt),
            ("gmm", x_sorted, wi), 2 * rows * H * Fd, 2 * (rows * H + E * H * Fd + rows * Fd)),
        "gmm down (K 14336, N 4096)": (
            lambda: gm.gmm(mid, wo, be, bt), lambda: gm.gmm_plain(mid, wo, be, bt),
            ("gmm", mid, wo), 2 * rows * H * Fd, 2 * (rows * Fd + E * H * Fd + rows * H)),
        "gmm dx trans_b (K 14336, N 4096)": (
            lambda: gm.gmm(mid, wi, be, bt, trans_b=True),
            lambda: gm.gmm_plain(mid, wi, be, bt, trans_b=True),
            ("gmm", mid, wi.transpose(1, 2)), 2 * rows * H * Fd,
            2 * (rows * Fd + E * H * Fd + rows * H)),
        "tgmm dw (K 4096, N 14336)": (
            lambda: gm.tgmm(x_sorted, mid, be, E, bt), lambda: gm.tgmm_plain(x_sorted, mid, be, E,
                                                                           bt),
            ("tgmm", x_sorted, mid), 2 * rows * H * Fd, 2 * (rows * H + rows * Fd) + 4 * E * H * Fd),
    }
    meas = {}
    for name, (fn, plain_fn, (kind, a, b), flops, n_bytes) in calls.items():
        ms = time_ms(fn, iters=10, warmup=2)
        plain = time_ms(plain_fn, iters=2, warmup=1)
        lib_name, lib_fn = _library_grouped(kind, a, b, be, bt, E)
        lib_ms = time_ms(lib_fn, iters=10, warmup=2)
        b_ms, b_by = bound_ms(n_bytes, flops)
        meas[name] = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                          library=lib_name, t_pad=T_pad, routed_rows=rows)
        log(f"[moe_kernels] {name}, {rows} routed rows (T_pad {T_pad}, bt {bt}): {ms:.3f} ms, "
            f"plain {plain:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {flops / 1e9:.1f} GFLOP, "
            f"{n_bytes / 1e9:.3f} GB), {lib_name} {lib_ms:.3f} ms; "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
    dw = gm.tgmm(x_sorted, mid, be, E, bt)
    cast_ms = time_ms(lambda: dw.to(torch.bfloat16), iters=10, warmup=2)
    cast_bound, _ = bound_ms(dw.numel() * (4 + 2), 0)
    log(f"[moe_kernels] tgmm's dw cast to bf16 (GroupedMatmul.backward's .to(rhs.dtype), "
        f"{dw.numel() / 1e9:.3f}e9 elements): {cast_ms:.3f} ms, bound {cast_bound:.4f} ms (bytes)")
    meas["tgmm dw (K 4096, N 14336)"]["dw_cast_ms"] = cast_ms
    del mid, dw

    # the serving modules at Mixtral width: grouped_gemm_moe vs
    # top_k_gated_moe (dense dispatch, plain products), a 512-token chunk
    # and an 8-token decode batch
    wg = (torch.randn(E, H, Fd, generator=gen, device=dev) / H**0.5).to(torch.bfloat16)
    gate_w = (torch.randn(H, E, generator=gen, device=dev) / H**0.5).to(torch.bfloat16)
    mods = {name: DSMoERegistry.instantiate_config(ConfigBundle(name=name, config=DSMoEConfig(
        n_experts=E, top_k=k, activation="swiglu", dtype=torch.bfloat16)))
        for name in ("grouped_gemm_moe", "top_k_gated_moe")}
    serve = {}
    for T in (512, 8):
        xs = torch.randn(T, H, generator=gen, device=dev).to(torch.bfloat16)
        before = gm.launch_counts["gmm"]
        got = mods["grouped_gemm_moe"](xs, gate_w, wi, wg, wo)
        n_launch = gm.launch_counts["gmm"] - before
        ref = mods["top_k_gated_moe"](xs, gate_w, wi, wg, wo)
        torch.cuda.synchronize()
        rel = float((got.float() - ref.float()).norm() / ref.float().norm())
        ms = time_ms(lambda: mods["grouped_gemm_moe"](xs, gate_w, wi, wg, wo), iters=10, warmup=2)
        dense_ms = time_ms(lambda: mods["top_k_gated_moe"](xs, gate_w, wi, wg, wo), iters=10,
                           warmup=2)
        serve[T] = dict(rel_l2=rel, ms=ms, dense_ms=dense_ms, gmm_launches=n_launch)
        log(f"[moe_kernels] serving module, {T} tokens: grouped_gemm_moe vs top_k_gated_moe "
            f"relative L2 {rel:.3e} (tolerance {MOE_SERVE_REL_L2_TOL}: both round up, gate, "
            f"activation and down to bf16 at the same places, from fp32 sums in another order); "
            f"{ms:.3f} ms vs {dense_ms:.3f} ms; gmm launches per call {n_launch}")
        if not (got.shape == (T, H) and rel <= MOE_SERVE_REL_L2_TOL and n_launch == 3):
            failures.append(f"serving module T={T}: rel L2 {rel:.3e}, gmm launches {n_launch}")
    del wi, wo, wg, x_sorted
    log(f"[moe_kernels] largest errors over all cases: gmm {worst['gmm'][1]:.3f} of its "
        f"tolerance ({worst['gmm'][2]}), tgmm {worst['tgmm'][1]:.3f} ({worst['tgmm'][2]})")
    if failures:
        raise RuntimeError("grouped matmul kernels disagree: " + "; ".join(failures[:12]))
    up = meas["gmm up (K 4096, N 14336)"]
    res = {"gmm": dict(err=worst["gmm"][0], **up, calls=meas, hgmma_in_sass=n_hgmma,
                       worst_error_fraction=worst["gmm"][1]),
           "tgmm": dict(err=worst["tgmm"][0], **meas["tgmm dw (K 4096, N 14336)"],
                        worst_error_fraction=worst["tgmm"][1])}
    res["gmm"]["serving_module"] = serve
    return res


# ---------------------------------------------------------------------------
# phase 5: Mistral-7B width trained through initialize -> train_batch
# ---------------------------------------------------------------------------

def _device_ms_by_name(prof):
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def _flash_share(by_name, busy):
    """The flash kernels' device time in a profiled step, top list or not."""
    parts = []
    for kernel in ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel"):
        t = sum(ms for n, ms in by_name.items() if kernel in n)
        parts.append(f"{kernel} {t:.2f} ms ({100 * t / busy:.1f}%)")
    return "flash kernels in the profiled step: " + ", ".join(parts)


def phase_train():
    """Returns (launches on the main path, the full-set fused Adam timing)."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] device memory in use before the model: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (the serving engine is freed)")
    t0 = time.perf_counter()
    cfg = mistral_config("7b", num_layers=TRAIN_LAYERS)
    model = TransformerLM(cfg, trainable=True, seed=0)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_DS_CONFIG)
    params = engine._params
    n_params = sum(p.numel() for p in params)
    torch.cuda.synchronize()
    log(f"[train] Mistral-7B width: hidden {cfg.hidden_size}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, intermediate {cfg.intermediate_size}, "
        f"vocab {cfg.vocab_size}, window {cfg.sliding_window}; depth cut 32 -> {TRAIN_LAYERS} "
        f"for memory (32 layers: 7.24e9 params x 16 B of fp32 params, grads, m, v = 116 GB); "
        f"{n_params / 1e9:.3f}B fp32 master params ({16 * n_params / 1e9:.1f} GB with grads and "
        f"moments); optimizer {type(optimizer).__name__}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    gas = engine.gradient_accumulation_steps()
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (engine.train_batch_size(), TRAIN_SEQ)).astype(np.int32)}
    tokens = batch["input_ids"].size
    ts = time.perf_counter()
    losses = [engine.train_batch(batch)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - ts
    fa.reset_launch_counts()
    fad.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        ts = time.perf_counter()
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    launches = {**fa.launch_counts, **fad.launch_counts}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    med = float(np.median(times))
    lrs = [float(engine.lr_schedule_fn(i)) for i in range(TIMED_STEPS + 1)]
    log(f"[train] {gas} microbatches x {TRAIN_SEQ} tokens = {tokens} tokens/step; losses "
        f"(warm step, then {TIMED_STEPS} timed; lr per step {lrs}): "
        f"{[round(x, 5) for x in losses]}")
    log(f"[train] step time median {1e3 * med:.1f} ms (range {1e3 * min(times):.1f}-"
        f"{1e3 * max(times):.1f}; warm step {1e3 * warm_s:.1f} ms): {tokens / med:.1f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    n_attn = TRAIN_LAYERS * gas * TIMED_STEPS
    log(f"[train] kernel launches on the main path: {launches} (expected flash {n_attn} each = "
        f"{TRAIN_LAYERS} layers x {gas} microbatches x {TIMED_STEPS} steps; fused_adam "
        f"{TIMED_STEPS})")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite and falling: {losses}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")

    # one profiled step: device busy vs wall, top device ops
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    log(f"[train] profiled step: wall {1e3 * wall:.1f} ms ({1e3 * med:.1f} unprofiled median), "
        f"device busy {busy:.1f} ms: device idle {100 * (1 - busy / (1e3 * med)):.1f}% of the "
        f"unprofiled step, {100 * (1 - busy / (1e3 * wall)):.1f}% of the profiled one")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[train]   {t:9.2f} ms  {100 * t / busy:5.1f}%  {name[:90]}")
    log(f"[train] {_flash_share(by_name, busy)}")

    # the fused AdamW at the full parameter set (lr 0: the params stay put)
    mu, nu, step = engine.adam_state()
    grads = [p.grad for p in params]
    one = torch.ones((), device="cuda")
    full_ms = time_ms(lambda: fad.fused_adam_apply(
        params, mu, nu, grads, lr_t=0.0, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
        step=step + 1, grad_scale=one, gate=one), iters=3, warmup=1)
    full_bound, _ = bound_ms(28 * n_params, 20 * n_params, FP32_FLOPS_PER_S)
    log(f"[train] fused_adam at the full parameter set ({n_params:,} elements, "
        f"{28 * n_params / 1e9:.1f} GB moved): {full_ms:.2f} ms, bound {full_bound:.2f} ms")
    full = dict(ms=full_ms, bound_ms=full_bound, elements=n_params)
    del mu, nu, grads

    # kernels vs the plain attention on the same weights at seq 1024
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CHECK_SEQ)).astype(np.int64))
    ids = ids.cuda()

    def loss_and_grads(impl):
        cfg.attention_impl = impl
        for p in params:
            p.grad = None
        loss = model.loss({"input_ids": ids})
        loss.backward()
        return loss.item(), [p.grad for p in params]

    l_k, g_k = loss_and_grads("flash")
    l_r, g_r = loss_and_grads("reference")
    cfg.attention_impl = "auto"
    num = sum(float((a.float() - b.float()).pow(2).sum()) for a, b in zip(g_k, g_r))
    den = sum(float(b.float().pow(2).sum()) for b in g_r)
    g_rel = (num / den)**0.5
    l_rel = abs(l_k - l_r) / abs(l_r)
    log(f"[train] seq {CHECK_SEQ} forward+backward, kernels vs plain attention on the same "
        f"weights: loss {l_k:.6f} vs {l_r:.6f} (relative {l_rel:.3e}, tolerance {LOSS_REL_TOL}); "
        f"whole-gradient relative L2 {g_rel:.3e} (tolerance {GRAD_REL_L2_TOL})")
    if not (np.isfinite(l_k) and l_rel <= LOSS_REL_TOL and g_rel <= GRAD_REL_L2_TOL):
        raise RuntimeError("kernel path disagrees with the plain attention")
    del engine, optimizer, model, params, g_k, g_r
    gc.collect()
    torch.cuda.empty_cache()
    return launches, full


# ---------------------------------------------------------------------------
# phases: activation checkpointing (remat) and the eager API
# ---------------------------------------------------------------------------

def _rel_l2(got, want):
    """sqrt(sum |got - want|^2 / sum |want|^2) over lists of tensors."""
    num = sum(float((a.float() - b.float()).pow(2).sum()) for a, b in zip(got, want))
    den = sum(float(b.float().pow(2).sum()) for b in want)
    return (num / den)**0.5


def _one_microbatch(model, params, batch, counters, generators=None):
    """One microbatch's forward and backward with every gradient dropped
    first and the launch counts of ``counters`` reset just before: (loss,
    the gradients, the launches)."""
    import torch

    for p in params:
        p.grad = None
    for mod in counters:
        mod.reset_launch_counts()
    gens = generators() if generators is not None else None
    loss = model.loss(batch, generator=gens) if gens is not None else model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    launches = {k: v for mod in counters for k, v in mod.launch_counts.items()}
    return float(loss.detach()), [p.grad for p in params], launches


def _remat_steps(engine, batch, counters, steps=REMAT_STEPS):
    """A warm ``train_batch``, then ``steps`` timed ones with the launch
    counts reset and the peak statistics cleared just before: (losses,
    median ms, peak GiB, launches a step)."""
    import numpy as np
    import torch

    engine.train_batch(batch)
    torch.cuda.synchronize()
    for mod in counters:
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(steps):
        ts = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        times.append(1e3 * (time.perf_counter() - ts))
    launches = {k: v / steps for mod in counters for k, v in mod.launch_counts.items()}
    return losses, float(np.median(times)), torch.cuda.max_memory_allocated() / 2**30, launches


def _cpu_checkpointing_check(n=4096):
    """``checkpointing.configure(checkpoint_in_cpu=True)`` on the card: a
    region's [n, n] fp32 input lives in pinned host memory from the forward
    to the recompute (the device holds that much less once the caller drops
    it), and the value and gradients equal those of the region kept on the
    device. Returns the device bytes held after the forward each way."""
    import torch

    from deepspeed_tpu_torch import checkpointing

    gen = torch.Generator(device="cuda").manual_seed(11)
    w = (torch.randn(n, n, device="cuda", generator=gen) / n**0.5).requires_grad_()
    x0 = torch.randn(n, n, device="cuda", generator=gen).requires_grad_()

    def region(h):
        return torch.tanh(h @ w) @ w

    runs = {}
    try:
        for offload in (False, True):
            checkpointing.configure(checkpoint_in_cpu=offload)
            h = x0 * 2.0
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            out = checkpointing.checkpoint(region, h)
            del h
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated() - base
            loss = out.pow(2).sum()
            grads = torch.autograd.grad(loss, [x0, w])
            runs[offload] = (float(loss.detach()), grads, held)
            del out, loss  # so the next run's count starts from the same tensors
    finally:
        checkpointing.reset()
    (l0, g0, h0), (l1, g1, h1) = runs[False], runs[True]
    equal = l0 == l1 and all(torch.equal(a, b) for a, b in zip(g0, g1))
    log(f"[remat] cpu_checkpointing on a [{n}, {n}] fp32 region: device bytes held after the "
        f"forward {h1:,} with the input on the host, {h0:,} without (the input is "
        f"{4 * n * n:,}); value and gradients equal: {equal}")
    failure = None
    if not equal or h0 - h1 < 4 * n * n - 2**20:
        failure = (f"cpu_checkpointing: equal {equal}, device bytes held {h1:,} against {h0:,} "
                   f"(the host copy should spare {4 * n * n:,})")
    return {"held_bytes": h1, "held_bytes_on_device": h0, "equal": equal, "failure": failure}


def phase_remat():
    """Returns the launches a ``train_batch`` step under each remat setting
    and the phase's record."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    L = TRAIN_LAYERS
    cfg = mistral_config("7b", num_layers=L)
    model = TransformerLM(cfg, trainable=True, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_DS_CONFIG)
    params = engine._params
    gas = engine.gradient_accumulation_steps()
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (engine.train_batch_size(), TRAIN_SEQ)).astype(np.int32)}
    mb = {"input_ids": torch.from_numpy(batch["input_ids"][:1]).cuda()}
    log(f"[remat] Mistral-7B width, depth {L}, the train phase's ds_config (gas {gas}, 1 x "
        f"{TRAIN_SEQ} tokens a microbatch); built in {time.perf_counter() - t0:.1f}s")
    settings = [("off", False, "nothing_saveable")] + [(p, True, p) for p in REMAT_POLICIES]
    worst, failures, record = 0.0, [], {"layers": L, "seq": TRAIN_SEQ, "gas": gas}

    # one microbatch's loss and gradients under each setting, against remat off
    ref = None
    record["grads"] = {}
    for name, remat, policy in settings:
        cfg.remat, cfg.remat_policy = remat, policy
        ts = time.perf_counter()
        loss, grads, n = _one_microbatch(model, params, mb, (fa, ))
        ms = 1e3 * (time.perf_counter() - ts)
        if ref is None:
            ref = (loss, grads)
            rel = 0.0
        else:
            rel = _rel_l2(grads, ref[1])
        want = {"flash_fwd": (2 if remat else 1) * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L}
        record["grads"][name] = {"loss": loss, "rel_l2": rel, "launches": n, "ms": ms}
        log(f"[remat] one microbatch, {name}: loss {loss:.6f} (remat off {ref[0]:.6f}); "
            f"gradients' relative L2 to remat off {rel:.3e} (tolerance {REMAT_REL_TOL}); flash "
            f"launches {n} (the design: {want}); {ms:.1f} ms with the first call's set-up")
        worst = max(worst, rel / REMAT_REL_TOL)
        if loss != ref[0] or rel > REMAT_REL_TOL:
            failures.append(f"{name}: loss {loss} vs {ref[0]}, gradients {rel:.3e}")
        if n != want:
            failures.append(f"{name}: flash launches {n}, the design says {want}")
    del ref, grads
    for p in params:
        p.grad = None

    # train_batch steps under each setting: peak, step time, launches a step
    record["steps"] = {}
    for name, remat, policy in settings:
        cfg.remat, cfg.remat_policy = remat, policy
        losses, med, peak, n = _remat_steps(engine, batch, (fa, fad))
        want = {"flash_fwd": (2 if remat else 1) * L * gas, "flash_bwd_dkdv": L * gas,
                "flash_bwd_dq": L * gas, "fused_adam": 1}
        record["steps"][name] = {"losses": losses, "step_ms": med, "peak_gib": peak,
                                 "launches": n}
        log(f"[remat] train_batch, {name}: step time median {med:.1f} ms over {REMAT_STEPS} "
            f"steps after a warm one; peak memory {peak:.2f} GiB; launches a step {n} (the "
            f"design: {want}); losses {[round(x, 5) for x in losses]}")
        if n != want:
            failures.append(f"{name}: launches a step {n}, the design says {want}")
        if not all(np.isfinite(losses)):
            failures.append(f"{name}: losses not finite: {losses}")
    off, on = record["steps"]["off"], record["steps"]["nothing_saveable"]
    log(f"[remat] nothing_saveable against remat off: peak {on['peak_gib']:.2f} vs "
        f"{off['peak_gib']:.2f} GiB ({off['peak_gib'] - on['peak_gib']:+.2f} GiB saved), step "
        f"{on['step_ms']:.1f} vs {off['step_ms']:.1f} ms ({on['step_ms'] / off['step_ms']:.3f}x)")
    if not on["peak_gib"] < off["peak_gib"]:
        failures.append(f"the peak under nothing_saveable, {on['peak_gib']:.2f} GiB, is not "
                        f"below remat off's, {off['peak_gib']:.2f}")
    cfg.remat = False
    launches = {name: st["launches"] for name, st in record["steps"].items()}
    del engine, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # MoE: Mixtral-8x7B's widths, the grouped path, top-2 with the Gumbel
    # second expert drawn from each row's generator, remat against none
    t0 = time.perf_counter()
    mcfg = mistral_config("7b", **dict(MOE_CONFIG, num_layers=REMAT_MOE_LAYERS))
    model = TransformerLM(mcfg, trainable=True, seed=0)
    params = [p for p in model.parameters() if p.requires_grad]
    mb = {"input_ids": torch.from_numpy(np.random.default_rng(1).integers(
        0, mcfg.vocab_size, (1, TRAIN_SEQ)).astype(np.int64)).cuda()}

    def generators():  # fresh each run, from the same seeds
        return [torch.Generator(device="cuda").manual_seed(7000 + b) for b in range(1)]

    mcfg.remat = False
    l_off, g_off, n_off = _one_microbatch(model, params, mb, (gm, fa), generators)
    mcfg.remat, mcfg.remat_policy = True, "nothing_saveable"
    l_on, g_on, n_on = _one_microbatch(model, params, mb, (gm, fa), generators)
    rel = _rel_l2(g_on, g_off)
    worst = max(worst, rel / REMAT_REL_TOL)
    record["moe"] = {"layers": REMAT_MOE_LAYERS, "loss": [l_off, l_on], "rel_l2": rel,
                     "launches": {"off": n_off, "nothing_saveable": n_on}}
    log(f"[remat] MoE (Mixtral-8x7B widths, {REMAT_MOE_LAYERS} layers, grouped, top-2 Gumbel, "
        f"one row's generator): loss {l_on:.6f} with remat, {l_off:.6f} without; gradients' "
        f"relative L2 {rel:.3e} (tolerance {REMAT_REL_TOL}); launches without remat {n_off}, "
        f"with {n_on}; {time.perf_counter() - t0:.1f}s")
    if l_on != l_off or rel > REMAT_REL_TOL:
        failures.append(f"MoE: loss {l_on} vs {l_off}, gradients {rel:.3e}")
    if any(n_on[k] <= n_off[k] for k in ("gmm", "flash_fwd")) or n_off["tgmm"] <= 0:
        failures.append(f"MoE launches: without remat {n_off}, with {n_on} (the recompute "
                        f"launches gmm and flash_fwd again)")
    launches["moe"] = n_on
    del model, params, g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()
    record["cpu_checkpointing"] = _cpu_checkpointing_check()
    if record["cpu_checkpointing"]["failure"]:
        failures.append(record["cpu_checkpointing"]["failure"])
    record["worst_error_fraction"] = worst
    log(f"[remat] worst_error_fraction={worst:.3f} (the gradients' relative L2 against remat "
        f"off over {REMAT_REL_TOL}, dense policies and MoE)")
    if failures:
        raise RuntimeError("remat disagrees: " + "; ".join(failures))
    return launches, record


def phase_eager():
    """Returns the launches of the eager steps and the phase's record."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad

    gc.collect()
    torch.cuda.empty_cache()
    cfg = mistral_config("7b", num_layers=TRAIN_LAYERS)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab_size, (2, TRAIN_SEQ)).astype(np.int32)
               for _ in range(EAGER_STEPS)]
    runs = {}
    for eager in (False, True):
        t0 = time.perf_counter()
        model = TransformerLM(cfg, trainable=True, seed=0)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_DS_CONFIG)
        gas, micro = engine.gradient_accumulation_steps(), engine.train_micro_batch_size_per_gpu()
        torch.cuda.synchronize()
        for mod in (fa, fad):
            mod.reset_launch_counts()
        losses = []
        for ids in batches:
            if eager:
                for i in range(gas):
                    loss = engine({"input_ids": ids[i * micro:(i + 1) * micro]})
                    engine.backward(loss)
                    engine.step()
                losses.append(float(engine._step_metrics["loss"]))
            else:
                losses.append(float(engine.train_batch({"input_ids": ids})))
        torch.cuda.synchronize()
        n = {**fa.launch_counts, **fad.launch_counts}
        params = [p.detach().clone() for p in engine._params]
        runs[eager] = (losses, params, n, engine.global_steps)
        log(f"[eager] {'forward / backward / step' if eager else 'train_batch'}: "
            f"{EAGER_STEPS} steps at gas {gas}, losses {losses}, global_steps "
            f"{engine.global_steps}, launches {n}; {time.perf_counter() - t0:.1f}s with the build")
        del engine, model, params
        gc.collect()
        torch.cuda.empty_cache()
    (l0, p0, n0, s0), (l1, p1, n1, s1) = runs[False], runs[True]
    rel = _rel_l2(p1, p0)
    log(f"[eager] eager against train_batch: losses equal {l1 == l0}; parameters after step "
        f"{EAGER_STEPS}: relative L2 {rel:.3e} (tolerance {EAGER_REL_TOL}); launches equal "
        f"{n1 == n0}")
    record = {"losses": l1, "train_batch_losses": l0, "params_rel_l2": rel, "launches": n1,
              "worst_error_fraction": rel / EAGER_REL_TOL}
    log(f"[eager] worst_error_fraction={rel / EAGER_REL_TOL:.3f}")
    del p0, p1
    gc.collect()
    torch.cuda.empty_cache()
    if l1 != l0 or rel > EAGER_REL_TOL or n1 != n0 or s1 != s0 or min(n1.values()) <= 0:
        raise RuntimeError(f"eager disagrees with train_batch: losses {l1} vs {l0}, parameters "
                           f"{rel:.3e}, launches {n1} vs {n0}, steps {s1} vs {s0}")
    return n1, record


# ---------------------------------------------------------------------------
# phase: ZeRO stages 0-3 at data-parallel world size >= 2
# ---------------------------------------------------------------------------

def _free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _zero_rank_ids(rank, gas):
    """Rank ``rank``'s ids of a zero-phase step: ``gas`` microbatches of 1 x
    ZERO_SEQ (the same batch every step)."""
    import numpy as np

    rng = np.random.default_rng(1000 + rank)
    return rng.integers(0, ZERO_VOCAB, (gas, ZERO_SEQ)).astype(np.int32)


def _zero_train(engine, batch, steps=ZERO_STEPS):
    """``steps`` steps of ``batch``: (losses, gradient norms, step ms)."""
    import torch

    losses, norms, times = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        norms.append(float(engine.get_global_grad_norm()))
    return losses, norms, times


def _zero_replica_rel_l2(engine):
    """The largest relative L2 difference of a parameter of ``engine`` to
    rank 0's (each broadcast from rank 0; the copies die here, before the
    next stage's peak is read)."""
    from deepspeed_tpu_torch import comm

    worst = 0.0
    for v in engine.module_state_dict().values():
        ref = comm.broadcast(v.clone(), src=0)
        worst = max(worst, float((v - ref).norm() / ref.norm().clamp_min(1e-30)))
    return worst


def _zero_rank_run(layers, stages, out_path):
    """One rank of the zero phase (``--zero-rank``; the environment holds
    RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as torchrun's
    does): for each stage (``"3r"``: stage 3 with ``remat``), Mistral-7B's
    width at ``layers`` layers from seed 0 through ``initialize`` ->
    ``train_batch`` on this rank's rows, with the launch counts reset just
    before the steps and read just after. Writes {stage: losses, gradient
    norms, step ms, peak GiB, launches, the partition's gathers a step, the
    largest relative L2 difference of a parameter after the steps to rank
    0's (not at full depth, where gathering every master would not fit)} as
    JSON to ``out_path``."""
    import datetime
    import gc

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad

    deepspeed_tpu_torch.init_distributed(dist_backend=os.environ["ZERO_BACKEND"], verbose=False,
                                         timeout=datetime.timedelta(minutes=3))
    rank, world = comm.get_rank(), comm.get_world_size()
    out = {"rank": rank, "world": world, "backend": comm.get_backend(),
           "device": str(torch.cuda.current_device()), "stages": {}}
    from deepspeed_tpu_torch.runtime.zero import partition

    cfg = mistral_config("7b", num_layers=layers)
    gathered, gathers = partition._gathered, [0]

    def counted(*a):  # the partition's group gathers (stage 3), forward and backward
        gathers[0] += 1
        return gathered(*a)

    partition._gathered = counted
    for case in map(str, stages):
        stage, cfg.remat = int(case.rstrip("r")), case.endswith("r")
        model = TransformerLM(cfg, trainable=True, seed=0)
        n_params = model.num_params()  # before stage 3 frees the full masters
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config=dict(ZERO_DS_CONFIG, zero_optimization={"stage": stage}))
        gas = engine.gradient_accumulation_steps()
        batch = {"input_ids": _zero_rank_ids(rank, gas)}  # this rank's rows
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        fad.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        gathers[0] = 0
        losses, norms, times = _zero_train(engine, batch)
        out["stages"][case] = {
            "losses": losses, "grad_norms": norms, "step_ms": times, "gas": gas,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "resident_gib": {k: v / 2**30 for k, v in engine.zero_resident_bytes().items()},
            "launches": {**fa.launch_counts, **fad.launch_counts}, "params": n_params,
            "gathers_per_step": gathers[0] / ZERO_STEPS}
        if layers != ZERO_FULL_LAYERS:
            out["stages"][case]["replica_rel_l2"] = _zero_replica_rel_l2(engine)
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    comm.barrier()
    comm.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _zero_spawn(world, backend, layers, stages, tag):
    """Run ``world`` ranks of ``_zero_rank_run`` (this script with
    ``--zero-rank``; ``_moe_zero_rank_run`` where ``stages`` are impl:stage
    cases, ``_tp_rank_run`` where they are ``tp:`` cases), one process each,
    each writing its output to ``build/zero/<tag>_rank<r>.log``, and return
    their results. A rank that fails or outlives ``ZERO_TIMEOUT_S`` fails
    the phase at once (every rank is then killed, and the end of each
    rank's output printed)."""
    out_dir = os.path.join(HERE, "build", "zero")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), ZERO_BACKEND=backend)
    procs, paths, logs = [], [], []
    for r in range(world):
        paths.append(os.path.join(out_dir, f"{tag}_rank{r}.json"))
        if os.path.exists(paths[-1]):
            os.remove(paths[-1])
        logs.append(open(os.path.join(out_dir, f"{tag}_rank{r}.log"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--zero-rank", str(r), "--zero-layers",
             str(layers), "--zero-stages", ",".join(map(str, stages)), "--zero-out", paths[-1]],
            cwd=HERE, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=logs[-1],
            stderr=subprocess.STDOUT, text=True))
    deadline = time.perf_counter() + ZERO_TIMEOUT_S
    failed = []
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [f"rank {r} exited {c}" for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.perf_counter() > deadline:
                failed = [f"rank {r} still running after {ZERO_TIMEOUT_S} s"
                          for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, f in enumerate(logs):
        with open(f.name) as text:
            for line in text.read().splitlines()[-40:] if failed else []:
                log(f"[zero] rank {r}: {line}")
    if failed:
        raise RuntimeError(f"zero ranks failed: {failed}")
    results = []
    for path in paths:
        with open(path) as f:
            results.append(json.load(f))
    return results


def _zero_world1(world, layers, config=None):
    """Stage 0 at world size 1 in this process on the global batch of the
    zero phase's ``world`` ranks (micro ``world``: rank r's row of each
    microbatch at r), with ``config`` (default ZERO_DS_CONFIG): (losses,
    gradient norms, step ms)."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config

    model = TransformerLM(mistral_config("7b", num_layers=layers), trainable=True, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(config or ZERO_DS_CONFIG, train_micro_batch_size_per_gpu=world))
    gas = engine.gradient_accumulation_steps()
    ids = np.stack([_zero_rank_ids(r, gas) for r in range(world)], axis=1)
    out = _zero_train(engine, {"input_ids": ids.reshape(gas * world, ZERO_SEQ)})
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_zero():
    """Returns the launches of each training kernel per rank and the
    phase's record (world, backend, per-stage peaks and step times)."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    n_dev = torch.cuda.device_count()
    world, backend = (min(4, n_dev), "nccl") if n_dev >= 2 else (2, "gloo")
    layers = ZERO_NCCL_LAYERS if backend == "nccl" else ZERO_GLOO_LAYERS
    stages = (0, 1, 2, 3)
    log(f"[zero] {world} ranks over {backend} on {n_dev} visible device(s)"
        + (" (two ranks share the card: NCCL takes one rank a device)" if n_dev < 2 else "")
        + f"; Mistral-7B width, depth cut 32 -> {layers}, 1 x {ZERO_SEQ} tokens a rank a "
        f"microbatch, gas 2, bf16, fused AdamW, clipping 1.0, lr 1e-3; stages {stages}, "
        f"{ZERO_STEPS} steps each from seed 0")
    t0 = time.perf_counter()
    w1_losses, w1_norms, w1_ms = _zero_world1(world, layers)
    log(f"[zero] world size 1, micro {world}, the same global batch, stage 0: losses "
        f"{[round(x, 5) for x in w1_losses]}; gradient norms {[round(x, 5) for x in w1_norms]}; "
        f"step ms {[round(t, 1) for t in w1_ms]} ({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    ranks = _zero_spawn(world, backend, layers, stages + ("3r", ), "stages")
    log(f"[zero] ranks done in {time.perf_counter() - t0:.1f}s")
    base = ranks[0]["stages"]["0"]["losses"]
    base_norms = ranks[0]["stages"]["0"]["grad_norms"]
    # world size N against 1: stage 0's losses and gradient norms
    w1 = max(_rel(base, w1_losses), _rel(base_norms, w1_norms))
    log(f"[zero] stage 0 at world size {world} against world size 1: losses "
        f"{[round(x, 5) for x in base]}, gradient norms {[round(x, 5) for x in base_norms]}; "
        f"largest relative difference {w1:.3e} (tolerance {ZERO_WORLD1_REL_TOL})")
    worst = 0.0  # stages 1-3 against stage 0
    replica = 0.0  # the ranks' parameters against rank 0's (replicas: 0)
    launches = {}
    record = {"world": world, "backend": backend, "layers": layers, "seq": ZERO_SEQ,
              "params": ranks[0]["stages"]["0"]["params"], "peak_gib": {}, "step_ms": {},
              "losses": {}, "world1": {"losses": w1_losses, "grad_norms": w1_norms,
                                       "step_ms": w1_ms, "rel_diff": w1}}
    for stage in map(str, stages):
        peaks = [r["stages"][stage]["peak_gib"] for r in ranks]
        step_ms = float(np.median([t for r in ranks for t in r["stages"][stage]["step_ms"][1:]]))
        losses = ranks[0]["stages"][stage]["losses"]
        for r in ranks:
            got = r["stages"][stage]
            rel = max(_rel(got["losses"], base), _rel(got["grad_norms"], base_norms))
            worst = max(worst, rel)
            replica = max(replica, got["replica_rel_l2"])
            for name, n in got["launches"].items():
                launches.setdefault(name, [0] * world)[r["rank"]] += n
            resident = {k: round(v, 3) for k, v in got["resident_gib"].items()}
            log(f"[zero] stage {stage} rank {r['rank']}: losses "
                f"{[round(x, 5) for x in got['losses']]}, gradient norms "
                f"{[round(x, 5) for x in got['grad_norms']]} (largest relative difference to "
                f"stage 0: {rel:.3e}); parameters against rank 0's: largest relative L2 "
                f"{got['replica_rel_l2']:.3e}; step ms {[round(t, 1) for t in got['step_ms']]}; "
                f"peak "
                f"{got['peak_gib']:.2f} GiB; resident {resident} GiB; launches {got['launches']}")
            n_attn = layers * got["gas"] * ZERO_STEPS
            want = {"flash_fwd": n_attn, "flash_bwd_dkdv": n_attn, "flash_bwd_dq": n_attn,
                    "fused_adam": ZERO_STEPS}
            if any(got["launches"].get(k, 0) != v for k, v in want.items()):
                raise RuntimeError(f"zero stage {stage} rank {r['rank']}: launches "
                                   f"{got['launches']}, expected {want}")
        record["peak_gib"][stage] = peaks
        record["step_ms"][stage] = step_ms
        record["losses"][stage] = losses
    log(f"[zero] peak GiB per rank by stage: {record['peak_gib']}; median step ms (steps 2-"
        f"{ZERO_STEPS}, every rank): {record['step_ms']}")
    record["rel_diff_to_stage0"] = worst
    # stage 3 with remat against stage 3 without: the same losses and norms,
    # a peak no higher, as many gathers (the recompute's replace the saved
    # weights' regathers), flash_fwd twice a layer a microbatch
    rel_r, remat_failures = 0.0, []
    for r in ranks:
        got, st3 = r["stages"]["3r"], r["stages"]["3"]
        rel = max(_rel(got["losses"], st3["losses"]), _rel(got["grad_norms"], st3["grad_norms"]))
        rel_r = max(rel_r, rel)
        replica = max(replica, got["replica_rel_l2"])
        n_attn = layers * got["gas"] * ZERO_STEPS
        want = {"flash_fwd": 2 * n_attn, "flash_bwd_dkdv": n_attn, "flash_bwd_dq": n_attn,
                "fused_adam": ZERO_STEPS}
        log(f"[zero] stage 3 with remat, rank {r['rank']}: losses "
            f"{[round(x, 5) for x in got['losses']]} (largest relative difference to stage 3 "
            f"without remat, losses and norms: {rel:.3e}); peak {got['peak_gib']:.2f} GiB "
            f"(without remat {st3['peak_gib']:.2f}); gathers a step {got['gathers_per_step']} "
            f"(without remat {st3['gathers_per_step']}); step ms "
            f"{[round(t, 1) for t in got['step_ms']]}; launches {got['launches']}")
        if got["launches"] != want:
            remat_failures.append(f"rank {r['rank']} launches {got['launches']}, expected {want}")
        if got["peak_gib"] > st3["peak_gib"]:
            remat_failures.append(f"rank {r['rank']} peak {got['peak_gib']:.2f} GiB above stage "
                                  f"3's {st3['peak_gib']:.2f}")
        if got["gathers_per_step"] != st3["gathers_per_step"]:
            remat_failures.append(f"rank {r['rank']} gathers a step {got['gathers_per_step']}, "
                                  f"stage 3's {st3['gathers_per_step']}")
    record["remat_stage3"] = {
        "rel_diff_to_stage3": rel_r, "peak_gib": [r["stages"]["3r"]["peak_gib"] for r in ranks],
        "gathers_per_step": ranks[0]["stages"]["3r"]["gathers_per_step"],
        "step_ms": float(np.median([t for r in ranks for t in r["stages"]["3r"]["step_ms"][1:]]))}
    fraction = max(worst / ZERO_REL_TOL, w1 / ZERO_WORLD1_REL_TOL, replica / ZERO_REL_TOL,
                   rel_r / ZERO_REL_TOL)
    log(f"[zero] worst_error_fraction={fraction:.3f} (the largest of: stages 1-3 against stage "
        f"0, {worst:.3e} over {ZERO_REL_TOL}; world size {world} against 1, {w1:.3e} over "
        f"{ZERO_WORLD1_REL_TOL}; a rank's parameters against rank 0's, which must be equal, "
        f"{replica:.3e} over {ZERO_REL_TOL}; stage 3 with remat against without, {rel_r:.3e} "
        f"over {ZERO_REL_TOL})")
    if not all(np.isfinite(base)) or not base[-1] < base[0]:
        raise RuntimeError(f"stage 0 losses not finite and falling: {base}")
    failures = [f"stages 1-3 against stage 0: relative {worst:.3e} > {ZERO_REL_TOL}"
                if worst > ZERO_REL_TOL else None,
                f"world size {world} against 1: relative {w1:.3e} > {ZERO_WORLD1_REL_TOL}"
                if w1 > ZERO_WORLD1_REL_TOL else None,
                f"a rank's parameters differ from rank 0's: relative L2 {replica:.3e}"
                if replica > 0 else None,
                f"stage 3 with remat against without: relative {rel_r:.3e} > {ZERO_REL_TOL}"
                if rel_r > ZERO_REL_TOL else None] + remat_failures
    if any(failures):
        raise RuntimeError(f"zero disagrees: {'; '.join(f for f in failures if f)}")
    for r in range(world):
        seq = [record["peak_gib"][str(s)][r] for s in stages]
        if not all(b < a for a, b in zip(seq, seq[1:])):
            raise RuntimeError(f"rank {r}'s peak memory does not fall with the stage: {seq}")
    if world == 4 and backend == "nccl":
        t0 = time.perf_counter()
        full = _zero_spawn(world, backend, ZERO_FULL_LAYERS, (3, "3r"), "full")
        for case, key in (("3", "full_depth_stage3"), ("3r", "full_depth_stage3_remat")):
            st = [r["stages"][case] for r in full]
            record[key] = {
                "layers": ZERO_FULL_LAYERS, "params": st[0]["params"],
                "peak_gib": [x["peak_gib"] for x in st], "losses": st[0]["losses"],
                "gathers_per_step": st[0]["gathers_per_step"],
                "step_ms": float(np.median([t for x in st for t in x["step_ms"][1:]]))}
            log(f"[zero] full depth ({ZERO_FULL_LAYERS} layers, {st[0]['params']:,} params) at "
                f"stage 3{' with remat' if case == '3r' else ''} over {world} cards: {record[key]}")
            if not all(np.isfinite(st[0]["losses"])):
                raise RuntimeError(f"full-depth stage {case} losses not finite: {st[0]['losses']}")
        log(f"[zero] full depth in {time.perf_counter() - t0:.1f}s; peak GiB a rank with remat "
            f"{record['full_depth_stage3_remat']['peak_gib']} beside "
            f"{record['full_depth_stage3']['peak_gib']} without")
    return launches, record


# ---------------------------------------------------------------------------
# phase: MoE at data-parallel world size >= 2, the experts over the ranks
# ---------------------------------------------------------------------------

def _moe_zero_cfg(layers, impl):
    from deepspeed_tpu_torch.models import mistral_config

    return mistral_config("7b", **dict(MOE_CONFIG, num_layers=layers, moe_impl=impl))


def _gate_top2(cfg, embedding, first, ids):
    """The first layer's top-2 expert sets [S, 2] of the tokens ``ids`` [1,
    S] from the ``embedding`` and the first block's weights ``first``
    (deterministic gating; the experts are not read)."""
    import torch

    from deepspeed_tpu_torch.models import transformer as tr

    with torch.no_grad():
        x = embedding.to(cfg.dtype)[ids]
        sin, cos = tr.rope_table(cfg, torch.arange(ids.shape[1], device=ids.device))
        x = x + tr._attn_branch(cfg, first, tr._norm(x, first["ln1_scale"], None, cfg.norm,
                                                     cfg.norm_eps), sin, cos)
        h = tr._norm(x, first["ln2_scale"], None, cfg.norm, cfg.norm_eps)
        logits = h.float()[0] @ first["gate_wg"].float()
    return logits.topk(cfg.moe_top_k, dim=-1).indices.sort(dim=-1).values


def _moe_layer_check(engine, cfg, rank):
    """The first block's MoE FFN through the engine's partition (this rank's
    experts: the slots exchanged with their owners on the einsum path, the
    experts gathered and their gradients reduce-scattered on the grouped
    path) against the same FFN on the whole fp32 experts, on one input of
    this rank (identical routing): relative L2 of y, dh and this rank's
    experts' gradients (the whole experts' gradients summed over the ranks
    into this rank's). The whole experts are the compute-dtype casts of
    the fp32 masters, which both paths multiply by."""
    import torch

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer as tr
    from deepspeed_tpu_torch.runtime.zero import partition

    z, dev = engine._zero, engine.device
    gen = torch.Generator(device=dev).manual_seed(50 + rank)
    h0 = torch.randn((1, CHECK_SEQ, cfg.hidden_size), generator=gen, device=dev).to(cfg.dtype)
    dy = torch.randn(h0.shape, generator=gen, device=dev)
    names = ("moe_wi", "moe_wg", "moe_wo")
    owned = dict(z.expert_leaves[2])  # block 0's experts: (key, parameter)
    for p in owned.values():
        p.grad.zero_()

    def run(layer):
        h = h0.clone().requires_grad_()
        y, _ = tr._moe_mlp(cfg, layer, h)
        (y.float() * dy).sum().backward()
        return y.detach(), h.grad

    with z.regather_in_backward():
        tree = engine.module.gathered_params(z.gather)
        layer = next(iter(tree["blocks"]))
        y, dh = run(layer)
    got = [owned[("blocks", 0, n)].grad.clone() for n in names]
    whole = {n: partition._gathered_expert(owned[("blocks", 0, n)].detach(), cfg.dtype,
                                           z.group).requires_grad_() for n in names}
    ref = dict(whole, gate_wg=layer["gate_wg"].detach())
    y_ref, dh_ref = run(ref)
    want = []
    for n, g in zip(names, got):
        want.append(comm.reduce_scatter_tensor(torch.empty_like(g), whole[n].grad.float(),
                                               group=z.group))
        whole[n].grad = None

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    out = {"y": rel(y, y_ref), "dh": rel(dh, dh_ref)}
    out.update({f"d{n}": rel(a, b) for n, a, b in zip(names, got, want)})
    del whole, ref, tree, layer
    return out


def _moe_replica_rel_l2(engine):
    """The largest relative L2 difference of a non-expert parameter group
    (its whole fp32 buffer) to rank 0's: each must be equal."""
    import torch

    from deepspeed_tpu_torch import comm

    z = engine._zero
    worst = 0.0
    for gi, fg in enumerate(z.groups):
        if z.stage == 3:
            flat = z.shards[gi].detach().new_empty(fg.padded)
            comm.all_gather_into_tensor(flat, z.shards[gi].detach(), group=z.group)
        else:
            flat = z.flats[gi]
        ref = comm.broadcast(flat.clone(), src=0)
        worst = max(worst, float((flat - ref).norm() / ref.norm().clamp_min(1e-30)))
        del ref
    torch.cuda.empty_cache()
    return worst


def _moe_zero_rank_run(layers, cases, out_path):
    """One rank of the moe_zero phase (``--zero-rank`` with ``--zero-moe``):
    for each (impl, stage) of ``cases``, Mixtral-8x7B's widths at
    ``layers`` layers from seed 0 through ``initialize`` -> ``train_batch``
    on this rank's rows, with the launch counts reset just before the steps
    and read just after. Writes, per case: losses, gradient norms, step ms,
    peak GiB, resident GiB, launches, whether this rank holds exactly its
    experts of the initial weights, the largest relative L2 difference of a
    non-expert group to rank 0's, the first layer's top-2 sets on the
    first microbatch after the steps, (not at depth MOE_ZERO_EP_LAYERS)
    the layer check, and the seconds of set-up, steps and checks."""
    import datetime
    import gc

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    deepspeed_tpu_torch.init_distributed(dist_backend=os.environ["ZERO_BACKEND"], verbose=False,
                                         timeout=datetime.timedelta(minutes=5))
    rank, world = comm.get_rank(), comm.get_world_size()
    out = {"rank": rank, "world": world, "backend": comm.get_backend(), "cases": {}}
    for impl, stage in cases:
        t0 = time.perf_counter()
        cfg = _moe_zero_cfg(layers, impl)
        model = TransformerLM(cfg, trainable=True, seed=0)
        n_params = model.num_params()
        e = cfg.moe_num_experts // world
        # this rank's experts of the first block's moe_wi, as every rank draws them
        want = model.tree["blocks"][0]["moe_wi"].detach()[rank * e:(rank + 1) * e].clone()
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model, config=dict(ZERO_DS_CONFIG, zero_optimization={"stage": stage}))
        mine = model.tree["blocks"][0]["moe_wi"].detach()
        owned_ok = mine.shape == want.shape and bool(torch.equal(mine, want))
        del want
        gas = engine.gradient_accumulation_steps()
        batch = {"input_ids": _zero_rank_ids(rank, gas)}
        torch.cuda.synchronize()
        for mod in (fa, fad, gm, sharded_moe):
            mod.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        losses, norms, times = _zero_train(engine, batch, MOE_ZERO_STEPS)
        t2 = time.perf_counter()
        launches = {**gm.launch_counts, **fa.launch_counts, **fad.launch_counts,
                    **sharded_moe.launch_counts}
        r = {"impl": impl, "stage": stage, "losses": losses, "grad_norms": norms,
             "step_ms": times, "gas": gas, "params": n_params, "launches": launches,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
             "resident_gib": {k: v / 2**30 for k, v in engine.zero_resident_bytes().items()},
             "owned_experts": [rank * e, (rank + 1) * e], "owned_ok": owned_ok,
             "replica_rel_l2": _moe_replica_rel_l2(engine)}
        z = engine._zero
        ids = torch.from_numpy(batch["input_ids"][:1].astype("int64")).to(engine.device)
        with z.regather_in_backward():
            r["top2"] = _gate_top2(cfg, z.gather(0)[("embed", "embedding")],
                                   {k[2]: t for k, t in z.gather(2).items()}, ids).tolist()
        if layers != MOE_ZERO_EP_LAYERS:
            r["layer_check"] = _moe_layer_check(engine, cfg, rank)
        r["phase_s"] = {"setup": t1 - t0, "steps": t2 - t1, "checks": time.perf_counter() - t2}
        out["cases"][f"{impl}:{stage}"] = r
        del engine, model, z, mine
        gc.collect()
        torch.cuda.empty_cache()
    comm.barrier()
    comm.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _moe_zero_world1(world, layers, impl):
    """World size 1 in this process on the global batch of the moe_zero
    phase's ``world`` ranks, one row a microbatch in the ranks' order
    (micro 1, gas 2 x world: every product has the ranks' shapes, and row g
    of the step draws from the generator rank g % world's row does):
    (losses, gradient norms, step ms, the first layer's top-2 sets of each
    rank's first row after the steps)."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM

    cfg = _moe_zero_cfg(layers, impl)
    model = TransformerLM(cfg, trainable=True, seed=0)
    gas = ZERO_DS_CONFIG["gradient_accumulation_steps"]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=dict(
        ZERO_DS_CONFIG, gradient_accumulation_steps=gas * world))
    ids = np.stack([_zero_rank_ids(r, gas) for r in range(world)], axis=1)
    losses, norms, times = _zero_train(engine, {"input_ids": ids.reshape(gas * world, ZERO_SEQ)},
                                       MOE_ZERO_STEPS)
    tree = model.params()
    top2 = [_gate_top2(cfg, tree["embed"]["embedding"], tree["blocks"][0],
                       torch.from_numpy(ids[0, r:r + 1].astype("int64")).to(engine.device))
            .tolist() for r in range(world)]
    del engine, model, tree  # the tree holds the masters and their gradients
    gc.collect()
    torch.cuda.empty_cache()
    return losses, norms, times, top2


def _moe_zero_checks(ranks, layers, world1):
    """Check one spawn's cases. ``world1``: {impl: world size 1's (losses,
    norms, ms, top-2 sets)} or None. Returns (failures, the largest error as
    a fraction of its tolerance, launches {name: [per rank]}, record)."""
    import numpy as np

    failures, fractions, launches, record = [], [0.0], {}, {}
    cases = list(ranks[0]["cases"])
    for key in cases:
        impl, stage = key.split(":")
        got = [r["cases"][key] for r in ranks]
        base = got[0]
        per_mb = layers * base["gas"] * MOE_ZERO_STEPS
        want = {"flash_fwd": per_mb, "flash_bwd_dkdv": per_mb, "flash_bwd_dq": per_mb,
                "fused_adam": MOE_ZERO_STEPS,
                "gmm": 6 * per_mb if impl == "grouped" else 0,
                "tgmm": 3 * per_mb if impl == "grouped" else 0,
                "gmm_wmma": 0, "tgmm_wmma": 0,
                "all_to_all": 4 * per_mb if impl == "einsum" else 0}
        for r in ranks:
            c = r["cases"][key]
            for name, n in c["launches"].items():
                launches.setdefault(name, [0] * len(ranks))[r["rank"]] += n
            bad = {k: (c["launches"].get(k, 0), v) for k, v in want.items()
                   if c["launches"].get(k, 0) != v}
            if bad:
                failures.append(f"{key} rank {r['rank']}: launches (got, expected) {bad}")
            if not c["owned_ok"]:
                failures.append(f"{key} rank {r['rank']}: does not hold exactly experts "
                                f"{c['owned_experts']} of the initial weights")
            if c["replica_rel_l2"] > 0:
                failures.append(f"{key} rank {r['rank']}: a non-expert group differs from "
                                f"rank 0's by {c['replica_rel_l2']:.3e}")
            if c["losses"] != base["losses"]:
                failures.append(f"{key} rank {r['rank']}: losses {c['losses']} != rank 0's")
            for what, err in c.get("layer_check", {}).items():
                fractions.append(err / MOE_LAYER_REL_L2_TOL)
                if err > MOE_LAYER_REL_L2_TOL:
                    failures.append(f"{key} rank {r['rank']}: the layer check's {what} relative "
                                    f"L2 {err:.3e} > {MOE_LAYER_REL_L2_TOL}")
            resident = {k: round(v, 3) for k, v in c["resident_gib"].items()}
            a, b = c["owned_experts"]
            log(f"[moe_zero] {impl} stage {stage} rank {r['rank']} (experts [{a}, {b})): losses {[round(x, 5) for x in c['losses']]}, gradient "
                f"norms {[round(x, 5) for x in c['grad_norms']]}; step ms "
                f"{[round(t, 1) for t in c['step_ms']]}; peak {c['peak_gib']:.2f} GiB; resident "
                f"{resident} GiB; launches {c['launches']}; layer check "
                f"{ {k: float(f'{v:.3e}') for k, v in c.get('layer_check', {}).items()} }; "
                f"seconds {({k: round(v, 1) for k, v in c['phase_s'].items()})}")
        if not (np.all(np.isfinite(base["losses"])) and base["losses"][-1] < base["losses"][0]):
            failures.append(f"{key}: losses not finite and falling: {base['losses']}")
        rec = {"losses": base["losses"], "grad_norms": base["grad_norms"],
               "peak_gib": [c["peak_gib"] for c in got], "params": base["params"],
               "resident_gib": base["resident_gib"],
               "step_ms": float(np.median([t for c in got for t in c["step_ms"][1:]]))}
        if world1 is not None:
            w_losses, w_norms, _, w_top2 = world1[impl]
            l_rel, n_rel = _rel(base["losses"], w_losses), _rel(base["grad_norms"], w_norms)
            flips = sum(int(np.any(np.asarray(c["top2"]) != np.asarray(b), axis=-1).sum())
                        for c, b in zip(got, w_top2))
            n_tol = MOE_NORM_REL_TOL if flips == 0 else MOE_GRAD_REL_L2_TOL
            fractions += [l_rel / LOSS_REL_TOL, n_rel / n_tol]
            rec.update(world1_loss_rel=l_rel, world1_norm_rel=n_rel, routing_flips=flips)
            log(f"[moe_zero] {impl} stage {stage} at world size {len(ranks)} against world size "
                f"1: losses relative {l_rel:.3e} (tolerance {LOSS_REL_TOL}), gradient norms "
                f"relative {n_rel:.3e} (tolerance {n_tol}); the first layer's gate picks other "
                f"experts for {flips} of {len(ranks) * ZERO_SEQ} tokens (each rank's first row, "
                f"after the steps)")
            if l_rel > LOSS_REL_TOL or n_rel > n_tol:
                failures.append(f"{key} against world size 1: losses {l_rel:.3e}, norms "
                                f"{n_rel:.3e}")
        record[key] = rec
    by_impl = {}
    for key in cases:
        by_impl.setdefault(key.split(":")[0], []).append(ranks[0]["cases"][key])
    for impl, runs in by_impl.items():  # later stages against the first, one impl
        for c in runs[1:]:
            l_rel = _rel(c["losses"], runs[0]["losses"])
            n_rel = _rel(c["grad_norms"], runs[0]["grad_norms"])
            fractions += [l_rel / ZERO_REL_TOL, n_rel / ZERO_REL_TOL]
            record[f"{impl}:{c['stage']}"].update(stage_loss_rel=l_rel, stage_norm_rel=n_rel)
            log(f"[moe_zero] {impl} stage {c['stage']} against stage {runs[0]['stage']}: losses "
                f"relative {l_rel:.3e}, gradient norms relative {n_rel:.3e} (tolerance "
                f"{ZERO_REL_TOL})")
            if l_rel > ZERO_REL_TOL or n_rel > ZERO_REL_TOL:
                failures.append(f"{impl} stage {c['stage']} against stage {runs[0]['stage']}: "
                                f"losses {l_rel:.3e}, norms {n_rel:.3e}")
    if len(by_impl) == 2:  # einsum against grouped, the first case of each
        a, b = by_impl["einsum"][0], by_impl["grouped"][0]
        l_rel = _rel(a["losses"][:1], b["losses"][:1])
        n_rel = _rel(a["grad_norms"][:1], b["grad_norms"][:1])
        fractions += [l_rel / LOSS_REL_TOL, n_rel / MOE_NORM_REL_TOL]
        last = {"loss_rel": _rel(a["losses"][-1:], b["losses"][-1:]),
                "norm_rel": _rel(a["grad_norms"][-1:], b["grad_norms"][-1:])}
        if world1 is not None:  # the same gap with no partition and no collective
            w_e, w_g = world1["einsum"], world1["grouped"]
            last.update(world1_loss_rel=_rel(w_e[0][-1:], w_g[0][-1:]),
                        world1_norm_rel=_rel(w_e[1][-1:], w_g[1][-1:]))
        record["einsum_vs_grouped"] = {"loss_rel": l_rel, "norm_rel": n_rel, "last_step": last}
        log(f"[moe_zero] einsum (einsum:{a['stage']}) against grouped (grouped:{b['stage']}) at "
            f"the first step, on the same weights: losses relative {l_rel:.3e} (tolerance "
            f"{LOSS_REL_TOL}), gradient norms relative {n_rel:.3e} (tolerance "
            f"{MOE_NORM_REL_TOL}); at the last step, not held: "
            f"{ {k: float(f'{v:.3e}') for k, v in last.items()} }")
        if l_rel > LOSS_REL_TOL or n_rel > MOE_NORM_REL_TOL:
            failures.append(f"einsum against grouped at the first step: losses {l_rel:.3e}, "
                            f"norms {n_rel:.3e}")
    return failures, max(fractions), launches, record


def phase_moe_zero():
    """Returns the launches of each kernel per rank and the phase's record."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    n_dev = torch.cuda.device_count()
    world, backend = (min(4, n_dev), "nccl") if n_dev >= 2 else (2, "gloo")
    layers = MOE_ZERO_NCCL_LAYERS if backend == "nccl" else MOE_ZERO_GLOO_LAYERS
    log(f"[moe_zero] {world} ranks over {backend} on {n_dev} visible device(s); Mixtral-8x7B "
        f"widths (8 experts over the {world} ranks, top-2 with the Gumbel second expert, "
        f"capacity factor 1.25, rope_theta 1e6, no window), depth cut 32 -> {layers}, 1 x "
        f"{ZERO_SEQ} tokens a rank a microbatch, gas 2, bf16, fused AdamW, clipping 1.0, lr "
        f"1e-3; cases (impl:stage) {MOE_ZERO_CASES}, {MOE_ZERO_STEPS} steps each from seed 0")
    t0 = time.perf_counter()
    world1 = {impl: _moe_zero_world1(world, layers, impl) for impl in ("einsum", "grouped")}
    for impl, (losses, norms, ms, _) in world1.items():
        log(f"[moe_zero] world size 1, {impl}, micro 1, gas {2 * world}, the same global batch: "
            f"losses {[round(x, 5) for x in losses]}; gradient norms "
            f"{[round(x, 5) for x in norms]}; step ms {[round(t, 1) for t in ms]}")
    log(f"[moe_zero] world size 1 runs in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ranks = _zero_spawn(world, backend, layers, MOE_ZERO_CASES, "moe")
    log(f"[moe_zero] ranks done in {time.perf_counter() - t0:.1f}s")
    failures, fraction, launches, record = _moe_zero_checks(ranks, layers, world1)
    record = {"world": world, "backend": backend, "layers": layers, "seq": ZERO_SEQ,
              "cases": record,
              "world1": {impl: {"losses": v[0], "grad_norms": v[1], "step_ms": v[2]}
                         for impl, v in world1.items()}}
    if world == 4 and backend == "nccl":
        t0 = time.perf_counter()
        ep = _zero_spawn(world, backend, MOE_ZERO_EP_LAYERS, MOE_ZERO_EP_CASES, "moe_ep")
        f2, frac2, _, rec2 = _moe_zero_checks(ep, MOE_ZERO_EP_LAYERS, None)
        failures += f2
        fraction = max(fraction, frac2)
        record["ep4_depth8"] = rec2
        log(f"[moe_zero] depth {MOE_ZERO_EP_LAYERS}, EP {world}, cases {MOE_ZERO_EP_CASES} in "
            f"{time.perf_counter() - t0:.1f}s")
    log(f"[moe_zero] worst_error_fraction={fraction:.3f} (the largest of: the layer checks over "
        f"{MOE_LAYER_REL_L2_TOL}; losses against world size 1 and einsum against grouped over "
        f"{LOSS_REL_TOL}; gradient norms over {MOE_NORM_REL_TOL}, or {MOE_GRAD_REL_L2_TOL} where "
        f"tokens route otherwise; stages over {ZERO_REL_TOL})")
    if failures:
        raise RuntimeError("moe_zero disagrees: " + "; ".join(failures))
    return launches, record


# ---------------------------------------------------------------------------
# phase: tensor parallelism (the model mesh axis), training and serving
# ---------------------------------------------------------------------------

def _tp_prompts():
    """The v1 phase's prompts, one a wave (the same seed)."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(0, 32000, (B, S)).astype(np.int32) for B, S, _ in V1_WAVES]


def _tp_prefill(engine, prompt, new):
    """A prefill of ``prompt`` through the engine's weights into a cache as
    ``generate`` allocates it: (the last position's logits [B, V], whole;
    the first layer's keys and values at the prompt's positions, this rank's
    kv heads), fp32 numpy."""
    import torch

    from deepspeed_tpu_torch.models import transformer as tr

    cfg, tp = engine.model_config, engine.tp
    B, S = prompt.shape
    smax = -(-(S + new) // tr.V1_BLOCK) * tr.V1_BLOCK
    cache = tr.init_kv_cache(cfg, B, smax, tp=tp)
    with torch.no_grad():
        logits, cache = tr._forward_with_cache(cfg, engine.params, torch.from_numpy(prompt), cache,
                                               tp)
        last = tr._whole_logits(logits[:, -1], tp)
    return tuple(t.float().cpu().numpy() for t in (last, cache["k"][0, :, :S], cache["v"][0, :, :S]))


def _tp_profiled_busy(engine, prompt, new):
    """(device busy ms, the same without NCCL's kernels) of one profiled
    ``generate``: an NCCL all-reduce kernel runs while it waits for the
    other ranks, so its time is not the rank's compute."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(prompt, max_new_tokens=new)
        torch.cuda.synchronize()
    by_name = _device_ms_by_name(prof)
    return (sum(by_name.values()),
            sum(ms for name, ms in by_name.items() if "nccl" not in name.lower()))


def _tp_waves(engine, tag, out_dir=None):
    """The v1 waves through ``engine``: per wave its prefill (logits and the
    first layer's cache, saved as ``<out_dir>/<tag>_w<i>_{logits,k,v}.npy``
    where given), then ``generate`` of 1 token (also the warm-up) and of the
    wave's tokens with the paged launches counted, and (the first wave) the
    device time a decode step over ``1 + V1_PROFILE_STEPS`` tokens. Returns
    [{tokens, launches, ms, ...}] and the prefills."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.ops import paged_attention as pa

    waves, prefills = [], []
    for i, (prompt, (B, S, new)) in enumerate(zip(_tp_prompts(), V1_WAVES)):
        t0 = time.perf_counter()
        pre = _tp_prefill(engine, prompt, new)
        log(f"[tp] {tag} wave {i}: prefill check in {time.perf_counter() - t0:.1f}s")
        prefills.append(pre)
        if out_dir is not None:
            for name, a in zip(("logits", "k", "v"), pre):
                np.save(os.path.join(out_dir, f"{tag}_w{i}_{name}.npy"), a)
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=1)
        one = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        pa.reset_launch_counts()
        t0 = time.perf_counter()
        out = engine.generate(prompt, max_new_tokens=new)
        full = 1e3 * (time.perf_counter() - t0)
        w = {"batch": B, "prompt": S, "new": new, "tokens": out[:, S:].tolist(),
             "launches": dict(pa.launch_counts), "generate_1_ms": one, "generate_ms": full,
             "decode_wall_ms_per_step": (full - one) / (new - 1)}
        log(f"[tp] {tag} wave {i}: generate of 1 token {one:.1f} ms, of {new} {full:.1f} ms")
        if i == 0:
            ones, ns = (_tp_profiled_busy(engine, prompt, n) for n in (1, 1 + V1_PROFILE_STEPS))
            w["decode_device_ms_per_step"] = (ns[0] - ones[0]) / V1_PROFILE_STEPS
            w["decode_compute_ms_per_step"] = (ns[1] - ones[1]) / V1_PROFILE_STEPS
        waves.append(w)
    return waves, prefills


def _tp_replicated_rel(engine):
    """The largest relative L2 difference of a replicated parameter (the
    norm scales) to model rank 0's, broadcast over the model group; None at
    stage 3, whose parameters are shards."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel import groups
    from deepspeed_tpu_torch.runtime.zero.partition import is_model_parallel

    if engine.zero_optimization_stage() == 3 and engine.dp_world_size > 1:
        return None
    group = groups.get_model_parallel_group()
    src, worst = comm.get_global_rank(group, 0), 0.0
    for p in engine.module.parameters():
        if not is_model_parallel(p):
            ref = comm.broadcast(p.detach().clone(), src=src, group=group)
            worst = max(worst, float((p.detach() - ref).norm() / ref.norm().clamp_min(1e-30)))
    return worst


def _tp_train(data, model, stage, layers):
    """One training case of a tp rank: Mistral-7B's width at ``layers``
    layers, this rank's shards of the tree world rank 0 draws from seed 0
    (broadcast and sliced leaf by leaf), ``initialize`` over ``data x
    model`` at ``stage``, ZERO_STEPS steps of this data rank's rows with the
    launch counts reset just before and read just after, and the (query,
    kv) heads of every flash forward."""
    import gc

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.models.transformer import tensor_parallel
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.parallel import groups
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig

    t0 = time.perf_counter()
    groups.initialize_mesh(MeshConfig(data=data, model=model), "cuda")
    cfg = mistral_config("7b", num_layers=layers)
    net = TransformerLM(cfg, trainable=True, seed=0, tp=tensor_parallel(cfg))
    local_params = net.num_params()
    log(f"[tp] train {data}x{model} stage {stage}: this rank's shards built in "
        f"{time.perf_counter() - t0:.1f}s")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=net, config=dict(
        TP_DS_CONFIG, zero_optimization={"stage": stage},
        tpu={"pallas_fused_adam": "always", "mesh": {"data": data, "model": model}}))
    gas = engine.gradient_accumulation_steps()
    batch = {"input_ids": _zero_rank_ids(engine.dp_rank, gas)}
    heads, real = set(), fa.flash_fwd

    def counted(q, k, *a, **kw):
        heads.add((q.shape[2], k.shape[2]))
        return real(q, k, *a, **kw)

    fa.flash_fwd = counted
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    fad.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    r = {"data": data, "model": model, "stage": stage, "layers": layers, "gas": gas,
         "losses": [], "grad_norms": [], "step_ms": [], "replicated_rel_l2": []}
    try:
        for _ in range(ZERO_STEPS):
            t = time.perf_counter()
            r["losses"].append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            r["step_ms"].append(1e3 * (time.perf_counter() - t))
            r["grad_norms"].append(float(engine.get_global_grad_norm()))
            r["replicated_rel_l2"].append(_tp_replicated_rel(engine))
            log(f"[tp] train {data}x{model} stage {stage}: step in {r['step_ms'][-1]:.0f} ms, "
                f"loss {r['losses'][-1]:.5f}")
    finally:
        fa.flash_fwd = real
    r.update(launches={**fa.launch_counts, **fad.launch_counts},
             flash_heads=sorted(heads), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             local_params=local_params, setup_s=t1 - t0, steps_s=time.perf_counter() - t1,
             resident_gib={k: v / 2**30 for k, v in engine.zero_resident_bytes().items()})
    if layers != ZERO_FULL_LAYERS:
        r["whole_rel_l2_to_rank0"] = _zero_replica_rel_l2(engine)
    del engine, net
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _tp_serve(model, out_dir):
    """The serving case of a tp rank: Mistral-7B at full depth, this rank's
    shards of the tree world rank 0 draws from seed 0, through
    ``init_inference(tensor_parallel={"tp_size": model})``, on the v1 waves
    (:func:`_tp_waves`)."""
    import gc

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.models.transformer import tensor_parallel
    from deepspeed_tpu_torch.parallel import groups
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig

    t0 = time.perf_counter()
    groups.initialize_mesh(MeshConfig(data=-1, model=model), "cuda")
    cfg = mistral_config("7b")
    net = TransformerLM(cfg, seed=0, tp=tensor_parallel(cfg))
    log(f"[tp] serve tp_size {model}: this rank's shards built in "
        f"{time.perf_counter() - t0:.1f}s")
    engine = deepspeed_tpu_torch.init_inference(
        net, config={"dtype": "bfloat16", "tensor_parallel": {"tp_size": model}})
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    waves, _ = _tp_waves(engine, f"tp_serve_rank{comm.get_rank()}", out_dir)
    r = {"model": model, "build_s": built, "waves": waves,
         "heads": engine.tp.heads(engine.model_config)[:2],
         "local_params": net.num_params(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
         "waves_s": time.perf_counter() - t0 - built}
    del engine, net
    gc.collect()
    torch.cuda.empty_cache()
    return r


def _tp_rank_run(layers, cases, out_path):
    """One rank of the tp phase (``--zero-rank`` with ``tp:`` cases):
    ``tp:train:<data>:<model>:<stage>`` (:func:`_tp_train` at ``layers``)
    and ``tp:serve:<model>`` (:func:`_tp_serve`); writes their records as
    JSON to ``out_path`` (the serving prefills beside it)."""
    import datetime

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm

    deepspeed_tpu_torch.init_distributed(dist_backend=os.environ["ZERO_BACKEND"], verbose=False,
                                         timeout=datetime.timedelta(minutes=5))
    out = {"rank": comm.get_rank(), "world": comm.get_world_size(),
           "backend": comm.get_backend(), "cases": {}}
    for case in cases:
        kind, *sizes = case.split(":")[1:]
        if kind == "train":
            out["cases"][case] = _tp_train(*map(int, sizes), layers)
        else:
            out["cases"][case] = _tp_serve(int(sizes[0]), os.path.dirname(out_path))
    comm.barrier()
    comm.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def _tp_serve_world1():
    """``tp_size`` 1 in this process on the same weights (Mistral-7B from
    seed 0): the waves and their prefills; the engine is freed after."""
    import gc

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import mistral

    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(mistral("7b", seed=0),
                                                config={"dtype": "bfloat16"})
    waves, prefills = _tp_waves(engine, "tp_serve_world1")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[tp] tp_size 1 in this process: {time.perf_counter() - t0:.1f}s")
    return waves, prefills


def _tp_train_checks(ranks, world1, layers, world):
    """Each training case of every rank against world size 1 on its global
    batch (losses and gradient norms, ZERO_WORLD1_REL_TOL), the replicated
    leaves against model rank 0's after every step (equal), the launches
    (every layer's flash kernels a microbatch, on the rank's heads, one
    fused AdamW a step). Returns (failures, worst fraction, launches per
    kernel per rank, records)."""
    import numpy as np

    failures, fraction, launches, records = [], 0.0, {}, {}
    cases = [c for c in ranks[0]["cases"] if c.startswith("tp:train")]
    for case in cases:
        got = [r["cases"][case] for r in ranks]
        data, model, stage = got[0]["data"], got[0]["model"], got[0]["stage"]
        w1_losses, w1_norms, w1_ms = world1[data]
        worst = replica = 0.0
        nq, nkv = 32 // model, 8 // model
        for r, g in zip(ranks, got):
            rel = max(_rel(g["losses"], w1_losses), _rel(g["grad_norms"], w1_norms))
            worst = max(worst, rel)
            reps = [x for x in g["replicated_rel_l2"] if x is not None]
            replica = max([replica, *reps, g.get("whole_rel_l2_to_rank0", 0.0)])
            n_attn = layers * g["gas"] * ZERO_STEPS
            want = {"flash_fwd": n_attn, "flash_bwd_dkdv": n_attn, "flash_bwd_dq": n_attn,
                    "fused_adam": ZERO_STEPS}
            for name, n in g["launches"].items():
                launches.setdefault(f"{case}", {}).setdefault(name, [0] * world)[r["rank"]] = n
            log(f"[tp] {case} rank {r['rank']}: losses {[round(x, 5) for x in g['losses']]}, "
                f"gradient norms {[round(x, 5) for x in g['grad_norms']]} (largest relative "
                f"difference to world size 1: {rel:.3e}); replicated leaves against model rank "
                f"0's after each step: {g['replicated_rel_l2']}; step ms "
                f"{[round(t, 1) for t in g['step_ms']]}; peak {g['peak_gib']:.2f} GiB; resident "
                f"{ {k: round(v, 3) for k, v in g['resident_gib'].items()} } GiB; "
                f"{g['local_params']:,} parameters on the rank; launches {g['launches']}; flash "
                f"(query, kv) heads {g['flash_heads']}; set-up {g['setup_s']:.1f}s")
            if any(g["launches"].get(k, 0) != v for k, v in want.items()):
                failures.append(f"{case} rank {r['rank']}: launches {g['launches']}, want {want}")
            if [list(h) for h in g["flash_heads"]] != [[nq, nkv]]:
                failures.append(f"{case} rank {r['rank']}: flash heads {g['flash_heads']}, want "
                                f"{[(nq, nkv)]}")
        log(f"[tp] {case} against world size 1 (micro {data}, the same global batch: losses "
            f"{[round(x, 5) for x in w1_losses]}, norms {[round(x, 5) for x in w1_norms]}, step "
            f"ms {[round(t, 1) for t in w1_ms]}): largest relative difference {worst:.3e} "
            f"(tolerance {ZERO_WORLD1_REL_TOL}); parameters against rank 0's {replica:.3e}")
        if worst > ZERO_WORLD1_REL_TOL:
            failures.append(f"{case} against world size 1: relative {worst:.3e} > "
                            f"{ZERO_WORLD1_REL_TOL}")
        if replica > 0:
            failures.append(f"{case}: replicated parameters differ from rank 0's: {replica:.3e}")
        if not all(np.isfinite(got[0]["losses"])) or not got[0]["losses"][-1] < got[0]["losses"][0]:
            failures.append(f"{case}: losses not finite and falling: {got[0]['losses']}")
        fraction = max(fraction, worst / ZERO_WORLD1_REL_TOL, replica / ZERO_REL_TOL)
        records[case] = {"losses": got[0]["losses"], "grad_norms": got[0]["grad_norms"],
                         "rel_diff_to_world1": worst, "peak_gib": [g["peak_gib"] for g in got],
                         "step_ms": float(np.median([t for g in got for t in g["step_ms"][1:]])),
                         "world1_step_ms": float(np.median(w1_ms[1:])),
                         "flash_heads": got[0]["flash_heads"]}
    by = {(g["data"], g["model"], g["stage"]): g for g in (ranks[0]["cases"][c] for c in cases)}
    if (2, 2, 1) in by and (2, 2, 3) in by:  # stage 3 against stage 1
        s1, s3 = by[(2, 2, 1)], by[(2, 2, 3)]
        rel = max(_rel(s3["losses"], s1["losses"]), _rel(s3["grad_norms"], s1["grad_norms"]))
        log(f"[tp] data 2 x model 2: stage 3 against stage 1, largest relative difference "
            f"{rel:.3e} (tolerance {ZERO_REL_TOL})")
        if rel > ZERO_REL_TOL:
            failures.append(f"stage 3 against stage 1: relative {rel:.3e} > {ZERO_REL_TOL}")
        fraction = max(fraction, rel / ZERO_REL_TOL)
    return failures, fraction, launches, records


def _tp_serve_checks(ranks, ref_waves, ref_prefills, out_dir):
    """Each rank's serving against ``tp_size`` 1: the prefill's last-token
    logits (rel L2 within LOGITS_REL_L2_TOL), the first layer's cache of the
    rank's kv heads (within TP_KV_REL_TOL), the tokens (equal on every rank;
    those that agree with ``tp_size`` 1 counted), the paged launches.
    Returns (failures, worst fraction, launches per kernel per rank,
    record)."""
    import numpy as np

    failures, fraction, launches, record = [], 0.0, {}, {"waves": []}
    case = [c for c in ranks[0]["cases"] if c.startswith("tp:serve")][0]
    world = len(ranks)
    for i, (ref, (ref_logits, ref_k, ref_v)) in enumerate(zip(ref_waves, ref_prefills)):
        B, S, new = ref["batch"], ref["prompt"], ref["new"]
        rels, kv_rels = [], []
        for r in ranks:
            g = r["cases"][case]
            w, (nq, nkv) = g["waves"][i], g["heads"]
            pre = [np.load(os.path.join(out_dir, f"tp_serve_rank{r['rank']}_w{i}_{n}.npy"))
                   for n in ("logits", "k", "v")]
            rels.append(float(np.linalg.norm(pre[0] - ref_logits) / np.linalg.norm(ref_logits)))
            heads = slice(r["rank"] * nkv, (r["rank"] + 1) * nkv)
            kv_rels.append(max(float(np.linalg.norm(got - want[:, :, heads])
                                     / np.linalg.norm(want[:, :, heads]))
                               for got, want in ((pre[1], ref_k), (pre[2], ref_v))))
            for name, n in w["launches"].items():
                launches.setdefault(name, [[0] * world for _ in ref_waves])[i][r["rank"]] = n
        tokens = [np.asarray(r["cases"][case]["waves"][i]["tokens"]) for r in ranks]
        same_ranks = all(np.array_equal(t, tokens[0]) for t in tokens)
        agree = int((tokens[0] == np.asarray(ref["tokens"])).sum())
        w0 = ranks[0]["cases"][case]["waves"][i]
        log(f"[tp] serving wave {B} x {S} + {new}, tp_size {world}: prefill last-token logits "
            f"against tp_size 1, rel L2 per rank {[f'{x:.3e}' for x in rels]} (tolerance "
            f"{LOGITS_REL_L2_TOL}); the first layer's cache of each rank's kv heads against "
            f"tp_size 1's, rel L2 {[f'{x:.3e}' for x in kv_rels]} (tolerance {TP_KV_REL_TOL}); "
            f"tokens equal on every rank: {same_ranks}; {agree} of {tokens[0].size} agree with "
            f"tp_size 1; launches per rank "
            f"{[r['cases'][case]['waves'][i]['launches'] for r in ranks]}; "
            f"decode {w0['decode_wall_ms_per_step']:.3f} ms/step wall (tp_size 1: "
            f"{ref['decode_wall_ms_per_step']:.3f})"
            + (f", device busy {w0['decode_device_ms_per_step']:.3f} ms/step, "
               f"{w0['decode_compute_ms_per_step']:.3f} without NCCL's kernels (tp_size 1: "
               f"{ref['decode_device_ms_per_step']:.3f})" if i == 0 else ""))
        if max(rels) > LOGITS_REL_L2_TOL:
            failures.append(f"wave {i}: prefill logits rel L2 {max(rels):.3e} > "
                            f"{LOGITS_REL_L2_TOL}")
        if max(kv_rels) > TP_KV_REL_TOL:
            failures.append(f"wave {i}: first-layer cache rel L2 {max(kv_rels):.3e} > "
                            f"{TP_KV_REL_TOL}")
        if not same_ranks:
            failures.append(f"wave {i}: the ranks emitted different tokens")
        # the first wave's 128-slot cache decodes in one split, the second's
        # 1024 in several, merged (the v1 phase's routes)
        want = (("paged_prefill", "paged_decode") if i == 0 else
                ("paged_prefill", "paged_decode_split", "paged_decode_merge"))
        missing = [k for k in want if not w0["launches"].get(k)]
        if missing:
            failures.append(f"wave {i}: paged kernels never launched: {missing}")
        fraction = max(fraction, max(rels) / LOGITS_REL_L2_TOL, max(kv_rels) / TP_KV_REL_TOL)
        record["waves"].append({
            "batch": B, "prompt": S, "new": new, "logits_rel_l2": max(rels),
            "first_layer_kv_rel_l2": max(kv_rels), "tokens_agree": agree,
            "tokens": int(tokens[0].size),
            "decode_wall_ms_per_step": w0["decode_wall_ms_per_step"],
            "world1_decode_wall_ms_per_step": ref["decode_wall_ms_per_step"],
            **({"decode_device_ms_per_step": w0["decode_device_ms_per_step"],
                "decode_compute_ms_per_step": w0["decode_compute_ms_per_step"],
                "world1_decode_device_ms_per_step": ref["decode_device_ms_per_step"]}
               if i == 0 else {})})
    g0 = ranks[0]["cases"][case]
    record.update(peak_gib=[r["cases"][case]["peak_gib"] for r in ranks], build_s=g0["build_s"],
                  local_params=g0["local_params"], heads=g0["heads"])
    return failures, fraction, launches, record


def phase_tp():
    """Returns the tp launches of rows 1-7 per rank and the phase's record."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    n_dev = torch.cuda.device_count()
    world, backend = (min(4, n_dev), "nccl") if n_dev >= 2 else (2, "gloo")
    if backend == "nccl":
        layers, train = ZERO_NCCL_LAYERS, ["tp:train:2:2:1", "tp:train:2:2:3", "tp:train:1:4:0"]
    else:
        layers, train = TP_GLOO_LAYERS, ["tp:train:1:2:0"]
    log(f"[tp] {world} ranks over {backend} on {n_dev} visible device(s)"
        + (" (two ranks share the card)" if n_dev < 2 else "")
        + f"; training: Mistral-7B width, depth cut 32 -> {layers}, 1 x {ZERO_SEQ} tokens a "
        f"microbatch, gas 2, bf16, fused AdamW, clipping 1.0, lr 1e-4, {ZERO_STEPS} steps from "
        f"seed 0, cases {train}; serving: Mistral-7B at full depth through init_inference("
        f"tensor_parallel tp_size {world}) on the waves {V1_WAVES}")
    t0 = time.perf_counter()
    world1 = {d: _zero_world1(d, layers, TP_DS_CONFIG)
              for d in sorted({int(c.split(':')[2]) for c in train})}
    log(f"[tp] world size 1 training runs in {time.perf_counter() - t0:.1f}s")
    ref_waves, ref_prefills = _tp_serve_world1()
    out_dir = os.path.join(HERE, "build", "zero")
    t0 = time.perf_counter()
    ranks = _zero_spawn(world, backend, layers, train + [f"tp:serve:{world}"], "tp")
    log(f"[tp] ranks done in {time.perf_counter() - t0:.1f}s")
    failures, fraction, train_launches, train_record = _tp_train_checks(ranks, world1, layers,
                                                                        world)
    f2, frac2, serve_launches, serve_record = _tp_serve_checks(ranks, ref_waves, ref_prefills,
                                                               out_dir)
    failures += f2
    fraction = max(fraction, frac2)
    record = {"world": world, "backend": backend, "layers": layers, "seq": ZERO_SEQ,
              "train": train_record, "serve": serve_record}
    if world == 4 and backend == "nccl":
        t0 = time.perf_counter()
        full = _zero_spawn(world, backend, ZERO_FULL_LAYERS, ["tp:train:2:2:3"], "tp_full")
        st = [r["cases"]["tp:train:2:2:3"] for r in full]
        record["full_depth_stage3"] = {
            "layers": ZERO_FULL_LAYERS, "peak_gib": [x["peak_gib"] for x in st],
            "losses": st[0]["losses"], "grad_norms": st[0]["grad_norms"],
            "step_ms": [x["step_ms"] for x in st], "local_params": st[0]["local_params"],
            "setup_s": st[0]["setup_s"]}
        log(f"[tp] full depth ({ZERO_FULL_LAYERS} layers) at stage 3 over data 2 x model 2 in "
            f"{time.perf_counter() - t0:.1f}s: {record['full_depth_stage3']}")
        if not all(np.isfinite(st[0]["losses"])):
            failures.append(f"full-depth losses not finite: {st[0]['losses']}")
    log(f"[tp] worst_error_fraction={fraction:.3f} (the largest of: losses and gradient norms "
        f"against world size 1 over {ZERO_WORLD1_REL_TOL}; stage 3 against stage 1 and the "
        f"replicated leaves against model rank 0's over {ZERO_REL_TOL}; prefill logits against "
        f"tp_size 1 over {LOGITS_REL_L2_TOL}; the first layer's cache over {TP_KV_REL_TOL})")
    if failures:
        raise RuntimeError("tp disagrees: " + "; ".join(failures))
    launches = {name: {"train": {c: v[name] for c, v in train_launches.items() if name in v}}
                for name in TRAIN_KERNELS}
    launches.update({name: {"serve": serve_launches.get(name)} for name in KERNELS})
    return launches, record


# ---------------------------------------------------------------------------
# phase: a Mixtral-8x7B-width MoE trained through initialize -> train_batch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_grouped_matmul(gm):
    """The plain grouped path: within the block, ``gm.gmm`` / ``gm.tgmm``
    (which ``grouped_matmul``'s forward and backward call) are the plain
    versions, on any device."""
    saved = gm.gmm, gm.tgmm
    gm.gmm, gm.tgmm = gm.gmm_plain, gm.tgmm_plain
    try:
        yield
    finally:
        gm.gmm, gm.tgmm = saved


def phase_moe_train():
    """Returns the launches on the main path (gmm, tgmm, flash, fused Adam)
    and the step's measurements."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[moe_train] device memory in use before the model: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (earlier engines freed)")
    t0 = time.perf_counter()
    cfg = mistral_config("7b", **MOE_CONFIG)
    model = TransformerLM(cfg, trainable=True, seed=0)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_DS_CONFIG)
    params = engine._params
    n_params = sum(p.numel() for p in params)
    n_expert = sum(p.numel() for layer in model.params()["blocks"] for name, p in layer.items()
                   if name.startswith("moe_w"))
    torch.cuda.synchronize()
    log(f"[moe_train] Mixtral-8x7B width: hidden {cfg.hidden_size}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, intermediate {cfg.intermediate_size}, vocab {cfg.vocab_size}, "
        f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k} ({cfg.moe_impl}), capacity factor "
        f"{cfg.moe_capacity_factor}, rope_theta {cfg.rope_theta}, window {cfg.sliding_window}; "
        f"depth cut 32 -> {MOE_LAYERS} for memory (32 layers: 46.7e9 params x 16 B = 747 GB); "
        f"{n_params / 1e9:.3f}B fp32 master params ({n_expert / 1e9:.3f}B in experts; "
        f"{16 * n_params / 1e9:.1f} GB with grads and moments); optimizer "
        f"{type(optimizer).__name__}; gating generators (one a row) on "
        f"{engine.row_generators(0, 1)[0].device}; built in {time.perf_counter() - t0:.1f}s")
    gas = engine.gradient_accumulation_steps()
    rng = np.random.default_rng(1)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (engine.train_batch_size(), TRAIN_SEQ)).astype(np.int32)}
    tokens = batch["input_ids"].size
    ts = time.perf_counter()
    losses = [engine.train_batch(batch)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - ts
    for mod in (fa, fad, gm):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        ts = time.perf_counter()
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    launches = {**gm.launch_counts, **fa.launch_counts, **fad.launch_counts}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    med = float(np.median(times))
    per_mb = MOE_LAYERS * gas
    expected = {"gmm": 6 * per_mb * TIMED_STEPS, "tgmm": 3 * per_mb * TIMED_STEPS,
                "gmm_wmma": 0, "tgmm_wmma": 0, "flash_fwd": per_mb * TIMED_STEPS,
                "flash_bwd_dkdv": per_mb * TIMED_STEPS,
                "flash_bwd_dq": per_mb * TIMED_STEPS, "fused_adam": TIMED_STEPS}
    log(f"[moe_train] {gas} microbatches x {TRAIN_SEQ} tokens = {tokens} tokens/step; losses "
        f"(warm step, then {TIMED_STEPS} timed): {[round(x, 5) for x in losses]}")
    log(f"[moe_train] step time median {1e3 * med:.1f} ms (range {1e3 * min(times):.1f}-"
        f"{1e3 * max(times):.1f}; warm step {1e3 * warm_s:.1f} ms): {tokens / med:.1f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[moe_train] kernel launches on the main path over {TIMED_STEPS} steps: {launches} "
        f"(expected {expected}: per step {MOE_LAYERS} layers x {gas} microbatches x (3 forward + "
        f"3 dx) gmm, x 3 dw tgmm, all on the wgmma route, x 1 of each flash kernel; 1 fused "
        f"Adam)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite and falling: {losses}")
    if launches != expected:
        raise RuntimeError(f"kernel launches {launches} != expected {expected}")

    # one profiled step: device busy vs wall, top device ops
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    idle = 1 - busy / (1e3 * med)
    log(f"[moe_train] profiled step: wall {1e3 * wall:.1f} ms ({1e3 * med:.1f} unprofiled "
        f"median), device busy {busy:.1f} ms: device idle {100 * idle:.1f}% of the unprofiled "
        f"step, {100 * (1 - busy / (1e3 * wall)):.1f}% of the profiled one")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[moe_train]   {t:9.2f} ms  {100 * t / busy:5.1f}%  {name[:90]}")
    log(f"[moe_train] {_flash_share(by_name, busy)}")
    del prof

    # the grouped kernels vs the plain grouped path on the same weights at
    # seq 1024 (flash attention on both sides): (a) the last layer's MoE FFN
    # on one input, so both route alike; (b) the whole model, where the last
    # layer's gate sees inputs that differ in the last bf16 bit
    from deepspeed_tpu_torch.models import transformer as tr

    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CHECK_SEQ)).astype(np.int64)).cuda()
    tree = model.params()
    last = tree["blocks"][-1]
    moe_names = ("gate_wg", "moe_wi", "moe_wg", "moe_wo")

    def gate_input():
        """The last layer's MoE input and its top-2 expert sets."""
        with torch.no_grad():
            x = tree["embed"]["embedding"].to(cfg.dtype)[ids]
            sin, cos = tr.rope_table(cfg, torch.arange(CHECK_SEQ, device=ids.device))
            for layer in tree["blocks"][:-1]:
                x, _ = tr._block(cfg, x, layer, sin, cos)
            x = x + tr._attn_branch(cfg, last, tr._norm(x, last["ln1_scale"], None, cfg.norm,
                                                        cfg.norm_eps), sin, cos)
            h = tr._norm(x, last["ln2_scale"], None, cfg.norm, cfg.norm_eps)
            logits = h.float()[0] @ last["gate_wg"].float()
        return h, logits.topk(cfg.moe_top_k, dim=-1).indices.sort(dim=-1).values

    h_k, sel_k = gate_input()
    with plain_grouped_matmul(gm):
        _, sel_r = gate_input()
    flips = int((sel_k != sel_r).any(dim=-1).sum())
    dy = torch.randn(h_k.shape, generator=torch.Generator(device=h_k.device).manual_seed(5),
                     device=h_k.device)

    def layer_grads():
        h = h_k.detach().clone().requires_grad_()
        y, _ = tr._moe_mlp(cfg, last, h)
        grads = torch.autograd.grad((y.float() * dy).sum(), [h] + [last[n] for n in moe_names])
        return [y.detach()] + list(grads)

    def layer_grads_plain():
        with plain_grouped_matmul(gm):
            return layer_grads()

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    lay = [rel_l2(a, b) for a, b in zip(layer_grads(), layer_grads_plain())]
    log(f"[moe_train] seq {CHECK_SEQ}, the last layer's MoE FFN on one input (identical routing), "
        f"kernels vs the plain grouped path, relative L2 (tolerance {MOE_LAYER_REL_L2_TOL}): "
        f"y {lay[0]:.3e}, dh {lay[1]:.3e}, "
        + ", ".join(f"d{n} {e:.3e}" for n, e in zip(moe_names, lay[2:])))

    def loss_and_grads():
        for p in params:
            p.grad = None
        loss = model.loss({"input_ids": ids})
        loss.backward()
        return loss.item(), [p.grad for p in params]

    l_k, g_k = loss_and_grads()
    with plain_grouped_matmul(gm):
        l_r, g_r = loss_and_grads()
    num = sum(float((a.float() - b.float()).pow(2).sum()) for a, b in zip(g_k, g_r))
    den = sum(float(b.float().pow(2).sum()) for b in g_r)
    g_rel = (num / den)**0.5
    l_rel = abs(l_k - l_r) / abs(l_r)
    log(f"[moe_train] seq {CHECK_SEQ} whole model forward+backward, grouped kernels vs the plain "
        f"grouped path on the same weights: loss {l_k:.6f} vs {l_r:.6f} (relative {l_rel:.3e}, "
        f"tolerance {LOSS_REL_TOL}); whole-gradient relative L2 {g_rel:.3e} (tolerance "
        f"{MOE_GRAD_REL_L2_TOL}); the last layer's gate picks other experts for {flips} of "
        f"{CHECK_SEQ} tokens (its inputs differ in the last bf16 bit)")
    if not (max(lay) <= MOE_LAYER_REL_L2_TOL and np.isfinite(l_k) and l_rel <= LOSS_REL_TOL
            and g_rel <= MOE_GRAD_REL_L2_TOL):
        raise RuntimeError("grouped kernel path disagrees with the plain grouped path")
    step = dict(step_ms=1e3 * med, tokens_per_s=tokens / med, peak_gib=peak / 2**30,
                idle_share=idle, losses=losses, layer_rel_l2=max(lay), loss_rel=l_rel,
                grad_rel_l2=g_rel, routing_flips=flips)
    del engine, optimizer, model, params, g_k, g_r
    gc.collect()
    torch.cuda.empty_cache()
    return launches, step


# ---------------------------------------------------------------------------
# phase: block-sparse attention, the kernel against its plain version
# ---------------------------------------------------------------------------

def _sparse_layout(kind, H, L, block):
    """A (H, nb, nb) int8 layout of the port's sparsity configs."""
    import numpy as np

    from deepspeed_tpu_torch.ops import sparse_attention as sa

    if kind == "slice":  # the slice's ds_config block, at this block size
        return sa.build_sparsity_config(dict(SPARSE_SA, block=block), H).make_layout(L)
    if kind == "bigbird":
        return sa.BigBirdSparsityConfig(H, block, different_layout_per_head=True,
                                        num_random_blocks=2, seed=3).make_layout(L)
    if kind == "longformer":
        return sa.BSLongformerSparsityConfig(H, block, num_sliding_window_blocks=3,
                                             global_block_indices=[0, 2]).make_layout(L)
    if kind == "variable":
        return sa.VariableSparsityConfig(H, block, different_layout_per_head=True,
                                         num_random_blocks=1, local_window_blocks=[2, 3],
                                         global_block_indices=[1], attention="unidirectional",
                                         seed=5).make_layout(L)
    if kind == "local":
        return sa.LocalSlidingWindowSparsityConfig(H, block).make_layout(L)
    layout = sa.FixedSparsityConfig(H, block, num_local_blocks=2).make_layout(L)
    layout[:, 1::3] = 0  # every third block row empty: those rows must write zeros
    return np.ascontiguousarray(layout)


def _visible_pairs(layout, block, causal):
    """(query, key) pairs a layout leaves visible (causal: key <= query):
    the work this layout's data needs."""
    import numpy as np

    H, nb, _ = layout.shape
    diff = np.arange(nb)[:, None] - np.arange(nb)[None, :]  # row - column
    per = (np.where(diff > 0, block * block, np.where(diff == 0, block * (block + 1) // 2, 0))
           if causal else np.full((nb, nb), block * block))
    return int((layout.astype(np.int64) * per[None]).sum())


def _sparse_inputs(seed, B, H, L, d, dtype, rpe=False, kp=None, am=None, causal=False):
    """q, k, v as [B, H, L, d] views of [B, L, H, d] buffers (the model's
    strides), dout, and the mask arguments, from a seeded generator."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: (torch.randn(B, L, H, d, generator=gen, device="cuda")  # noqa: E731
                  .to(dtype).transpose(1, 2))
    q, k, v, do = mk(), mk(), mk(), mk()
    kw = dict(causal=causal)
    if rpe:
        kw["rpe"] = torch.randn(L, L, generator=gen, device="cuda")
    for name, shape, mode in (("key_padding_mask", (B, L), kp), ("attn_mask", (L, L), am)):
        if mode == "mul":
            kw[name] = (torch.rand(shape, generator=gen, device="cuda") > 0.2).float()
        elif mode == "add":
            kw[name] = torch.randn(shape, generator=gen, device="cuda")
        if mode is not None:
            kw[f"{name}_mode"] = mode
    if kp == "mul":
        kw["key_padding_mask"][-1] = 0.0  # a fully padded sample: every row masked, zeros
    return q, k, v, do, kw


def _sparse_main_times(bsa, F, q, k, v, lut, nvalid, layout, block):
    """The kernel of q's route at the main shape (CUDA events), its plain
    version, and SDPA with the layout and causality as a boolean [1, H, L, L]
    mask (it computes every score of the full matrix); with max |sdpa -
    kernel|."""
    import torch

    L = q.shape[2]
    ms = time_ms(lambda: bsa.block_sparse_fwd(q, k, v, lut, nvalid, block, causal=True),
                 iters=20, warmup=3)
    plain = time_ms(lambda: bsa.block_sparse_attention_gathered(q, k, v, lut, nvalid, block,
                                                                causal=True), iters=3, warmup=1)
    lay = torch.as_tensor(layout, device="cuda").bool()
    mask = (lay.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)
            & torch.ones(L, L, dtype=torch.bool, device="cuda").tril())[None]
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask), iters=5,
                  warmup=2)
    lib_err = float((F.scaled_dot_product_attention(qc, kc, vc, attn_mask=mask).float()
                     - bsa.block_sparse_fwd(q, k, v, lut, nvalid, block, causal=True).float())
                    .abs().max())
    return ms, plain, lib, lib_err


def phase_sparse_kernels():
    """Returns {"block_sparse_fwd": measurement dict}: the tensor-core
    route's numbers (bf16), with the fp32 route's under ``fp32_route``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    worst = {"": 0.0, "_fp32": 0.0}  # max_abs_err by route
    worst_frac = [0.0, ""]  # the largest fraction of the tolerance, its case

    def check(tag, q, k, v, layout, block, kw):
        lut, nvalid = (torch.as_tensor(x, device="cuda") for x in bsa.make_layout_lut(layout))
        out = bsa.block_sparse_fwd(q, k, v, lut, nvalid, block, **kw)
        ref = bsa.block_sparse_attention_gathered(q, k, v, lut, nvalid, block, **kw)
        torch.cuda.synchronize()
        e, frac = _flash_err(out, ref)
        sfx = bsa._SUFFIX[bsa.route(q.dtype)]
        worst[sfx] = max(worst[sfx], e)
        if frac > worst_frac[0]:
            worst_frac[:] = [frac, tag]
        if not frac <= 1.0:
            failures.append(f"{tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")
        if not bool(torch.isfinite(out).all()):
            failures.append(f"{tag}: non-finite output")
        return out, ref, lut, nvalid

    log("[sparse_kernels] tensor-core kernel, ptxas registers and spills:")
    mma = ("block_sparse_mma_kernel", "block_sparse_union_kernel")  # the walk that is built
    _log_ptxas(bsa.kernel_build().ptxas, "[sparse_kernels]", mma)
    # at d 64 and d 128 (template argument ILi64E / ILi128E) it must not spill
    entries = _ptxas_entries(bsa.kernel_build().ptxas, mma)
    wide = {n: e for n, e in entries.items() if "ILi64E" in n or "ILi128E" in n}
    if len(wide) != 4 or any(e[1] or e[2] for e in wide.values()):
        failures.append(f"the d 64 / 128 tensor-core kernels: {wide} (4 kernels, no spill "
                        f"expected)")
    smem = bsa.kernel_build().lib.ds_block_sparse_smem_bytes
    log(f"[sparse_kernels] d 64 / 128 on the tensor cores, registers / spill stores / loads "
        f"(bytes): {sorted(wide.values())}; shared memory a CTA at d 128: tensor cores "
        f"{smem(0, 128)} B, fp32 route {smem(1, 128)} B")

    # small shapes: every block size, head_dim 32 / 64 / 128, the three
    # dtypes, rpe, both mask modes, per-head layouts, empty rows, a fully
    # padded sample. Every case runs on both routes: in its dtype and in
    # the other route's (fp32 for a 16-bit case, bf16 for an fp32 one);
    # each launch is expected on its dtype's route
    cases = [  # (layout, B, H, L, d, block, dtype, causal, rpe, kp, am)
        ("slice", 2, 4, 512, 128, 16, torch.bfloat16, True, False, None, None),
        ("slice", 2, 4, 512, 64, 32, torch.bfloat16, True, True, "mul", "mul"),
        ("bigbird", 2, 4, 512, 64, 32, torch.bfloat16, False, True, "mul", "add"),
        ("longformer", 2, 2, 512, 64, 64, torch.float16, False, False, "add", "add"),
        ("bigbird", 1, 2, 512, 128, 128, torch.float32, False, True, None, "mul"),
        ("variable", 2, 4, 256, 128, 32, torch.bfloat16, True, False, "add", None),
        ("empty_rows", 1, 2, 384, 64, 16, torch.bfloat16, False, False, None, None),
        ("empty_rows", 2, 2, 384, 128, 16, torch.float32, True, True, "mul", None),
        ("local", 1, 4, 256, 32, 16, torch.bfloat16, True, False, None, "mul"),
        ("slice", 1, 2, 256, 32, 64, torch.float16, True, True, "add", "add"),
    ]
    bsa.reset_launch_counts()
    expected = dict.fromkeys(bsa.launch_counts, 0)
    for i, (kind, B, H, L, d, block, dtype, causal, rpe, kp, am) in enumerate(cases):
        layout = _sparse_layout(kind, H, L, block)
        for dt in (dtype, torch.bfloat16 if dtype == torch.float32 else torch.float32):
            q, k, v, _, kw = _sparse_inputs(100 + i, B, H, L, d, dtype, rpe, kp, am, causal)
            q, k, v = (t.to(dt) for t in (q, k, v))  # the same values on the other route
            expected[f"block_sparse_fwd{bsa._SUFFIX[bsa.route(dt)]}"] += 1
            tag = (f"{kind} B={B} H={H} L={L} d={d} block={block} {str(dt)[6:]} causal={causal} "
                   f"rpe={rpe} kp={kp} am={am}")
            out, _, _, nvalid = check(tag, q, k, v, layout, block, kw)
            if kind == "empty_rows":  # rows with nvalid 0 write zeros
                rows = (nvalid == 0).repeat_interleave(block, dim=1)  # [H, L]
                if float(out.float().abs()[:, rows].max()) != 0.0:
                    failures.append(f"{tag}: an empty row is not zero")
            if kp == "mul" and float(out[-1].float().abs().max()) != 0.0:
                failures.append(f"{tag}: the fully padded sample is not zero")
    torch.cuda.synchronize()
    routes = dict(bsa.launch_counts)
    log(f"[sparse_kernels] small-shape matrix ({len(cases)} cases x both routes): "
        f"{'all within tolerance' if not failures else failures}; max_abs_err tensor cores "
        f"{worst['']:.3e}, fp32 route {worst['_fp32']:.3e}")
    log(f"[sparse_kernels] launches by route (bf16 / fp16 on the tensor cores, fp32 on the "
        f"'_fp32' CUDA-core kernel): {routes} (expected {expected})")
    if routes != expected:
        failures.append(f"launches by route {routes} != expected {expected}")

    # the main path's shape: one sample of the slice's model, its layout,
    # on both routes: bf16 (the path's) and the same values in fp32
    B, H, L, d, block = 1, 32, TRAIN_SEQ, 128, SPARSE_SA["block"]
    q, k, v, do, kw = _sparse_inputs(7, B, H, L, d, torch.bfloat16, causal=True)
    layout = _sparse_layout("slice", H, L, block)
    out, ref, lut, nvalid = check(f"main B={B} H={H} L={L} d={d} block={block} bf16 causal",
                                  q, k, v, layout, block, kw)
    main_err = float((out.float() - ref.float()).abs().max())
    del out, ref
    ms, plain, lib, lib_err = _sparse_main_times(bsa, F, q, k, v, lut, nvalid, layout, block)
    # the backward (the gathered form's recompute, plain torch ops, as the
    # JAX package computes it outside any kernel): time and transient peak
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o = bsa.block_sparse_attention(qg, kg, vg, layout, block, causal=True, lut=lut,
                                   nvalid=nvalid)
    bwd = lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True)  # noqa: E731
    bwd()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bwd()
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated() - base
    bwd_ms = time_ms(bwd, iters=3, warmup=1)
    del o, qg, kg, vg, do
    q32, k32, v32 = (t.float() for t in (q, k, v))
    del q, k, v
    out, ref, _, _ = check(f"main B={B} H={H} L={L} d={d} block={block} fp32 causal",
                           q32, k32, v32, layout, block, kw)
    main_err32 = float((out - ref).abs().max())
    del out, ref
    ms32, plain32, lib32, lib_err32 = _sparse_main_times(bsa, F, q32, k32, v32, lut, nvalid,
                                                         layout, block)
    del q32, k32, v32
    pairs = _visible_pairs(layout, block, causal=True)
    counts = layout.sum(-1)
    n_bytes = 4 * B * H * L * d * 2  # q, k, v read once, out written once, bf16
    flops = 4 * B * d * pairs  # q.k and p.v over the visible pairs
    b_ms, b_by = bound_ms(n_bytes, flops)
    b_ms32, b_by32 = bound_ms(2 * n_bytes, flops, FP32_FLOPS_PER_S)
    log(f"[sparse_kernels] layout at L={L}: {H} heads x {L // block} block rows, "
        f"{len(np.unique(layout, axis=0))} distinct head layouts, densest row A={counts.max()}, "
        f"mean {counts.mean():.2f} blocks; {pairs:,} visible (q, k) pairs = "
        f"{pairs / (H * L * L):.4f} of the full and {pairs / (H * L * (L + 1) / 2):.4f} of the "
        f"causal score matrix")
    res = {}
    for sfx, t_ms, p_ms, l_ms, l_err, bm, bb, nby, err in (
            ("", ms, plain, lib, lib_err, b_ms, b_by, n_bytes, main_err),
            ("_fp32", ms32, plain32, lib32, lib_err32, b_ms32, b_by32, 2 * n_bytes, main_err32)):
        log(f"[sparse_kernels] block_sparse_fwd{sfx} B={B} H={H} L={L} d={d} block={block} "
            f"{'fp32' if sfx else 'bf16'} causal (the model's strides): {t_ms:.4f} ms, plain "
            f"{p_ms:.3f} ms, bound {bm:.4f} ms ({bb}, {flops / 1e9:.2f} GFLOP, {nby / 1e6:.1f} "
            f"MB), sdpa with the layout as a boolean mask {l_ms:.4f} ms (max |sdpa - kernel| "
            f"{l_err:.3e}); main-shape max_abs_err {err:.3e}")
        m = dict(err=worst[sfx], ms=t_ms, plain_ms=p_ms, bound_ms=bm, bound_by=bb,
                 library_ms=l_ms,
                 library="F.scaled_dot_product_attention with the layout as a boolean mask")
        if sfx:
            res["block_sparse_fwd"]["fp32_route"] = m
        else:
            res["block_sparse_fwd"] = m
    log(f"[sparse_kernels] backward (gathered recompute over chunks of heads): {bwd_ms:.3f} ms, "
        f"transient peak {bwd_peak / 2**30:.2f} GiB")
    log(f"[sparse_kernels] largest error over all cases {worst_frac[0]:.3f} of its tolerance "
        f"({worst_frac[1]})")
    log(f"[sparse_kernels] worst_error_fraction={worst_frac[0]:.6g}")
    if failures:
        raise RuntimeError("block-sparse kernel disagrees with the plain version: "
                           + "; ".join(failures[:10]))
    res["block_sparse_fwd"].update(visible_pairs=pairs, densest_row=int(counts.max()),
                                   backward_ms=bwd_ms, backward_peak_gib=bwd_peak / 2**30)
    return res


# ---------------------------------------------------------------------------
# phase: a Llama-2-7B-width model with block-sparse attention trained through
# initialize -> train_batch
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_block_sparse(bsa):
    """The plain forward: within the block, ``bsa.block_sparse_fwd`` (which
    the autograd function's forward calls) is the gathered form, on any
    device. The backward is the same either way."""
    saved = bsa.block_sparse_fwd
    bsa.block_sparse_fwd = (lambda q, k, v, lut, nvalid, block, **kw:
                            bsa.block_sparse_attention_gathered(q, k, v, lut, nvalid, block, **kw))
    try:
        yield
    finally:
        bsa.block_sparse_fwd = saved


def phase_sparse_train():
    """Returns the launches on the main path (block-sparse, flash, fused
    Adam) and the step's measurements."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, llama2_config
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sparse_train] device memory in use before the model: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (earlier engines freed)")
    t0 = time.perf_counter()
    cfg = llama2_config("7b", num_layers=SPARSE_LAYERS, sparse_attention=SPARSE_SA)
    model = TransformerLM(cfg, trainable=True, seed=0)
    engine, optimizer, _, _ = deepspeed_tpu_torch.initialize(model=model, config=SPARSE_DS_CONFIG)
    params = engine._params
    n_params = sum(p.numel() for p in params)
    torch.cuda.synchronize()
    if engine.sparse_attention_config() != SPARSE_SA:
        raise RuntimeError(f"sparse_attention_config() {engine.sparse_attention_config()} != "
                           f"the ds_config's {SPARSE_SA}")
    log(f"[sparse_train] Llama-2-7B width: hidden {cfg.hidden_size}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, head_dim {cfg.head_dim}, intermediate {cfg.intermediate_size}, "
        f"vocab {cfg.vocab_size}, rope_theta {cfg.rope_theta}; sparse_attention {SPARSE_SA}; "
        f"depth cut 32 -> {SPARSE_LAYERS} for memory (32 layers: 6.74e9 params x 16 B = 108 GB); "
        f"{n_params / 1e9:.3f}B fp32 master params ({16 * n_params / 1e9:.1f} GB with grads and "
        f"moments); optimizer {type(optimizer).__name__}; built in "
        f"{time.perf_counter() - t0:.1f}s")
    gas = engine.gradient_accumulation_steps()
    rng = np.random.default_rng(2)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (engine.train_batch_size(), TRAIN_SEQ)).astype(np.int32)}
    tokens = batch["input_ids"].size
    ts = time.perf_counter()
    losses = [engine.train_batch(batch)]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - ts
    for mod in (bsa, fa, fad):
        mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        ts = time.perf_counter()
        losses.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    launches = {**bsa.launch_counts, **fa.launch_counts, **fad.launch_counts}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    med = float(np.median(times))
    expected = {"block_sparse_fwd": SPARSE_LAYERS * gas * TIMED_STEPS, "block_sparse_fwd_fp32": 0,
                "flash_fwd": 0, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0, "fused_adam": TIMED_STEPS}
    log(f"[sparse_train] {gas} microbatches x {TRAIN_SEQ} tokens = {tokens} tokens/step; losses "
        f"(warm step, then {TIMED_STEPS} timed): {[round(x, 5) for x in losses]}")
    log(f"[sparse_train] step time median {1e3 * med:.1f} ms (range {1e3 * min(times):.1f}-"
        f"{1e3 * max(times):.1f}; warm step {1e3 * warm_s:.1f} ms): {tokens / med:.1f} tokens/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"[sparse_train] kernel launches on the main path over {TIMED_STEPS} steps: {launches} "
        f"(expected {expected}: per step {SPARSE_LAYERS} layers x {gas} microbatches block-sparse "
        f"forwards on the tensor cores, none on the fp32 route, no flash, 1 fused Adam)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite and falling: {losses}")
    if launches != expected:
        raise RuntimeError(f"kernel launches {launches} != expected {expected}")

    # one profiled step: device busy vs wall, top device ops
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        engine.train_batch(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    idle = 1 - busy / (1e3 * med)
    log(f"[sparse_train] profiled step: wall {1e3 * wall:.1f} ms ({1e3 * med:.1f} unprofiled "
        f"median), device busy {busy:.1f} ms: device idle {100 * idle:.1f}% of the unprofiled "
        f"step, {100 * (1 - busy / (1e3 * wall)):.1f}% of the profiled one")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    for name, t in top:
        log(f"[sparse_train]   {t:9.2f} ms  {100 * t / busy:5.1f}%  {name[:90]}")
    del prof

    # the kernel vs the plain forward on the same weights at seq 1024 (the
    # backward is the gathered recompute on both sides)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CHECK_SEQ)).astype(np.int64)).cuda()

    def loss_and_grads():
        for p in params:
            p.grad = None
        loss = model.loss({"input_ids": ids})
        loss.backward()
        return loss.item(), [p.grad for p in params]

    l_k, g_k = loss_and_grads()
    with plain_block_sparse(bsa):
        l_r, g_r = loss_and_grads()
    num = sum(float((a.float() - b.float()).pow(2).sum()) for a, b in zip(g_k, g_r))
    den = sum(float(b.float().pow(2).sum()) for b in g_r)
    g_rel = (num / den)**0.5
    l_rel = abs(l_k - l_r) / abs(l_r)
    log(f"[sparse_train] seq {CHECK_SEQ} forward+backward, the kernel vs the plain forward on the "
        f"same weights: loss {l_k:.6f} vs {l_r:.6f} (relative {l_rel:.3e}, tolerance "
        f"{LOSS_REL_TOL}); whole-gradient relative L2 {g_rel:.3e} (tolerance {GRAD_REL_L2_TOL})")
    if not (np.isfinite(l_k) and l_rel <= LOSS_REL_TOL and g_rel <= GRAD_REL_L2_TOL):
        raise RuntimeError("block-sparse kernel path disagrees with the plain forward")
    step = dict(step_ms=1e3 * med, tokens_per_s=tokens / med, peak_gib=peak / 2**30,
                idle_share=idle, losses=losses, loss_rel=l_rel, grad_rel_l2=g_rel,
                top_device_ops=[(n[:60], round(t, 3)) for n, t in top[:5]])
    del engine, optimizer, model, params, g_k, g_r
    gc.collect()
    torch.cuda.empty_cache()
    return launches, step


# ---------------------------------------------------------------------------
# phase: the Evoformer attention kernels against their plain versions
# ---------------------------------------------------------------------------

def _evo_err(got, ref, kind, terms=None):
    """(max |got - ref|, the largest error as a fraction of its tolerance)
    for the Evoformer outputs (see the module docstring): ``"low"`` bf16 /
    fp16 outputs, ``"fp32"`` fp32 outputs, ``"lse"``, or a number of terms
    for the fp32 bias sums. ``terms``: the same sum over the absolute values
    of its terms (:func:`_evo_abs_terms`), for the gradients."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    if not err.numel():
        return 0.0, 0.0
    rms = float(ref.pow(2).mean().sqrt())
    if kind == "lse":
        tol = 2.0**-14 * (1.0 + ref.abs())
    elif kind == "low":
        tol = TOL_ULPS * bf16_ulp(ref) + max(TOL_FLOOR, GRAD_FLOOR_RMS * rms)
    elif kind == "fp32":
        tol = EVO_FP32_REL * ref.abs() + EVO_FP32_RMS * rms + 2.0**-30
    else:
        tol = TGMM_FLOOR * float(kind)**0.5 * rms + 2.0**-30
    if terms is not None:
        tol = tol + EVO_ABS_TERMS * terms
    return float(err.max()), float((err / tol).max())


def _evo_abs_terms(tev, q, k, v, b1, b2, out, lse, do):
    """(dq, dk, dv, db1, db2) summed over the absolute values of their
    terms, with ds taken as p (|dO| . |v| + rowsum |dO * O|): the scale that
    rounding in another order works on. It bounds the error where a
    gradient cancels to far below its terms (R 1: p = 1 and dp = delta, so
    ds is rounding alone on both sides)."""
    import torch

    N, R, h, d = q.shape
    scale = 1.0 / d**0.5
    s = tev._add_biases(scale * torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()), b1, b2)
    p = torch.exp(s - lse[..., None])
    ado, av = do.float().abs(), v.float().abs()
    adelta = (ado * out.float().abs()).sum(-1).permute(0, 2, 1)[..., None]
    a = p * (torch.einsum("nqhd,nkhd->nhqk", ado, av) + adelta)
    db2 = a.reshape(b2.shape[0], N // b2.shape[0], h, R, R).sum(1) if b2 is not None else None
    return (scale * torch.einsum("nhqk,nkhd->nqhd", a, k.float().abs()),
            scale * torch.einsum("nhqk,nqhd->nkhd", a, q.float().abs()),
            torch.einsum("nhqk,nqhd->nkhd", p, ado), a.sum(dim=(1, 2)), db2)


def _evo_case(seed, N, G, R, h, d, dtype, with_b1, with_b2, openfold=False):
    """q, k, v, dout [N, R, h, d] and the biases from a seeded generator;
    ``openfold``: bias1 = 1e9 (mask - 1) with the last residues padded and
    row 1 fully masked, where dout is 0 (the model masks those outputs)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    q, k, v, do = (mk(N, R, h, d).to(dtype) for _ in range(4))
    b1 = 2 * mk(N, R) if with_b1 else None
    b2 = mk(G, h, R, R) if with_b2 else None
    masked = None
    if openfold:
        mask = torch.ones(N, R, device="cuda")
        mask[:, R - R // 10:] = 0.0
        mask[1] = 0.0
        b1 = EVO_MASK_INF * (mask - 1.0)
        masked = mask.sum(-1) == 0  # [N] rows whose every key is masked
        do[masked] = 0
    return q, k, v, do, b1, b2, masked


def _evo_all(tev, q, k, v, do, b1, b2, db1=True):
    """Kernels: (out, lse, dq, dk, dv, db1, db2); the backward on the
    forward's own out and lse."""
    out, lse = tev.evo_fwd(q, k, v, b1, b2)
    dq = tev.evo_bwd_dq(q, k, v, b1, b2, out, lse, do)
    dk, dv, g1 = tev.evo_bwd_dkdv(q, k, v, b1, b2, out, lse, do, db1=db1)
    g2 = tev.evo_bwd_db2(q, k, v, b1, b2, out, lse, do) if b2 is not None else None
    return out, lse, dq, dk, dv, g1, g2


def _evo_bytes_flops(N, G, R, h, d, elem=2):
    """{kernel: (bytes each input read once and each output written once,
    FLOPs at 2 per multiply-add)} for one call with both biases, q/k/v of
    ``elem`` bytes (2: bf16, 4: fp32)."""
    T = N * R * h * d * elem  # q, k, v, out, dout, dq, dk, dv: each this size
    pairs = N * h * R * R
    bias = N * R * 4 + G * h * R * R * 4
    lse = N * h * R * 4
    return {"evo_fwd": (4 * T + bias + lse, 4 * d * pairs),
            "evo_bwd_dq": (6 * T + bias + lse, 6 * d * pairs),
            "evo_bwd_dkdv": (7 * T + bias + lse, 8 * d * pairs),
            "evo_bwd_db1": (5 * T + bias + lse + N * R * 4, 4 * d * pairs),
            "evo_bwd_db2": (5 * T + bias + lse + G * h * R * R * 4, 4 * d * pairs)}


def _ptxas_entries(report, keep):
    """{kernel: (registers, spill store bytes, spill load bytes)} from nvcc's
    ``-Xptxas -v`` report, for the kernels whose name holds one of ``keep``."""
    import re

    found, name = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            name = name if any(k in name for k in keep) else None
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            found[name] = (found.get(name, (None,))[0], int(st), int(ld))
        elif name and "Used" in line and "registers" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            found[name] = (regs, *found.get(name, (None, None, None))[1:])
    return found


def _evo_main_times(tev, q, k, v, do, b1, b2, out, lse):
    """The four kernels' times at the main shape on q's route (db1's: the
    dk/dv launch that sums it), the plain forward and backward, and the
    library yardstick: SDPA on [N, h, R, d] with bias1 + bias2 materialised
    as a float mask in q's dtype, its backward with the mask's gradient."""
    import torch
    import torch.nn.functional as F

    N, R, h, _ = q.shape
    ms = {"evo_fwd": time_ms(lambda: tev.evo_fwd(q, k, v, b1, b2), iters=10, warmup=2),
          "evo_bwd_dq": time_ms(lambda: tev.evo_bwd_dq(q, k, v, b1, b2, out, lse, do), iters=10,
                                warmup=2),
          "evo_bwd_dkdv": time_ms(lambda: tev.evo_bwd_dkdv(q, k, v, b1, b2, out, lse, do,
                                                           db1=False), iters=10, warmup=2),
          "evo_bwd_db2": time_ms(lambda: tev.evo_bwd_db2(q, k, v, b1, b2, out, lse, do),
                                 iters=10, warmup=2)}
    # db1 is summed inside the dk/dv kernel: its time is that launch's
    ms["evo_bwd_db1"] = time_ms(lambda: tev.evo_bwd_dkdv(q, k, v, b1, b2, out, lse, do),
                                iters=10, warmup=2)
    plain_fwd = time_ms(lambda: tev.evo_attention_reference(q, k, v, b1, b2), iters=3, warmup=1)
    plain_bwd = time_ms(lambda: tev.evo_attention_reference_bwd(q, k, v, b1, b2, out, lse, do),
                        iters=3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    mask = (b2.expand(N, h, R, R) + b1[:, None, None, :]).to(q.dtype).requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                      iters=10, warmup=2)
    o_lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = float((o_lib.detach().transpose(1, 2).float() - out.float()).abs().max())
    try:
        lib_bwd = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt, mask), dot,
                                                      retain_graph=True), iters=10, warmup=2)
        lib_note = "SDPA backward with the mask's gradient"
    except RuntimeError as e:  # a yardstick only: say what this torch computes
        lib_bwd = time_ms(lambda: torch.autograd.grad(o_lib, (qt, kt, vt), dot,
                                                      retain_graph=True), iters=10, warmup=2)
        lib_note = f"SDPA backward without the mask's gradient ({str(e)[:120]})"
    return ms, plain_fwd, plain_bwd, lib_fwd, lib_bwd, lib_note, lib_err


def phase_evo_kernels():
    """Returns {kernel name: measurement dict} for the Evoformer kernels:
    the tensor-core route's numbers (bf16), with the fp32 route's under
    ``fp32_route``."""
    import torch

    from deepspeed_tpu_torch.ops import evoformer_attention as tev

    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    worst = {name: 0.0 for name in EVO_KERNELS}
    worst_fp32 = {name: 0.0 for name in EVO_KERNELS}
    worst_frac = [0.0, ""]
    owner = {"out": "evo_fwd", "lse": "evo_fwd", "dq": "evo_bwd_dq", "dk": "evo_bwd_dkdv",
             "dv": "evo_bwd_dkdv", "db1": "evo_bwd_db1", "db2": "evo_bwd_db2"}

    def check(tag, got, q, k, v, do, b1, b2, masked=None):
        out, lse = got[0], got[1]
        r_out, r_lse = tev.evo_attention_reference(q, k, v, b1, b2)
        ref = (r_out, r_lse, *tev.evo_attention_reference_bwd(q, k, v, b1, b2, out, lse, do))
        terms = (None, None, *_evo_abs_terms(tev, q, k, v, b1, b2, out, lse, do))
        torch.cuda.synchronize()
        N, R, h, _ = q.shape
        low = "low" if q.dtype != torch.float32 else "fp32"
        kinds = {"out": low, "lse": "lse", "dq": low, "dk": low, "dv": low, "db1": h * R,
                 "db2": N // (b2.shape[0] if b2 is not None else 1)}
        by_route = worst if q.dtype != torch.float32 else worst_fp32
        errs = {}
        for name, a, r, t in zip(owner, got, ref, terms):
            if a is None:
                continue
            if name in ("out", "lse") and masked is not None:  # fully masked rows: finite
                if not bool(torch.isfinite(a[masked]).all()):
                    failures.append(f"{name} {tag}: non-finite on a fully masked row")
                a, r = a[~masked], r[~masked]
            e, frac = _evo_err(a, r, kinds[name], t)
            errs[name] = e
            by_route[owner[name]] = max(by_route[owner[name]], e)
            if frac > worst_frac[0]:
                worst_frac[:] = [frac, f"{name} {tag}"]
            if not frac <= 1.0:
                failures.append(f"{name} {tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")
        return errs

    # small cases: each bias present or absent, G 1 and 2, ragged R, every
    # head dim, OpenFold's mask with a fully masked row, an odd number of
    # rows a group (the two-row ablation's one-row tail), and db2 with one row a
    # group and with 32 rows a group in chunks. Every case runs on both
    # routes: in its dtype (bf16 / fp32 / fp16 in turn) and in the other
    # route's (fp32 for a 16-bit case, bf16 for an fp32 one); each launch is
    # expected on its dtype's route
    tev.reset_launch_counts()
    expected = dict.fromkeys(tev.launch_counts, 0)

    def run_case(tag, seed, N, G, R, h, d, dtype, with_b1, with_b2, openfold=False):
        for dt in (dtype, torch.bfloat16 if dtype == torch.float32 else torch.float32):
            q, k, v, do, b1, b2, masked = _evo_case(seed, N, G, R, h, d, dt, with_b1, with_b2,
                                                    openfold)
            got = _evo_all(tev, q, k, v, do, b1, b2)
            sfx = tev._SUFFIX[tev.route(dt)]
            expected[f"evo_fwd{sfx}"] += 1
            expected[f"evo_bwd_dq{sfx}"] += 1
            expected[f"evo_bwd_dkdv{sfx}"] += 1
            expected[f"evo_bwd_db1{sfx}"] += with_b1
            expected[f"evo_bwd_db2{sfx}"] += with_b2
            chunks = tev.db2_row_chunks(N // G, R, h, G) if with_b2 and not sfx else "-"
            check(f"{tag}N={N} G={G} R={R} h={h} d={d} {str(dt)[6:]} b1={with_b1} "
                  f"b2={with_b2} db2_chunks={chunks}", got, q, k, v, do, b1, b2, masked)

    dtypes = (torch.bfloat16, torch.float32, torch.float16)
    n_cases = 0
    for (R, d) in ((1, 32), (64, 32), (100, 32), (130, 64), (200, 128), (257, 32)):
        for with_b1, with_b2 in ((True, True), (True, False), (False, True), (False, False)):
            N = 4 if n_cases % 4 else 5  # both biases: 5 rows, one group (an odd one)
            run_case("", 200 + n_cases, N, 1 + (n_cases % 2) * (N % 2 == 0), R,
                     2 + 2 * (n_cases % 2), d, dtypes[n_cases % 3], with_b1, with_b2)
            n_cases += 1
    for dtype in (torch.bfloat16, torch.float32):
        run_case("openfold ", 300 + n_cases, 6, 2, 160, 4, 32, dtype, True, True, openfold=True)
        n_cases += 1
    run_case("", 300 + n_cases, 2, 2, 100, 2, 32, torch.float16, True, True)  # one row a group
    n_cases += 1
    run_case("", 300 + n_cases, 64, 2, 257, 4, 32, torch.bfloat16, True, True)  # 32 rows a group
    n_cases += 1
    torch.cuda.synchronize()
    routes = dict(tev.launch_counts)
    log(f"[evo_kernels] small-case matrix ({n_cases} cases x both routes x out, lse, dq, dk, dv, "
        f"db1, db2): {'all within tolerance' if not failures else failures[:5]}; max_abs_err "
        f"tensor cores { {k_: f'{e_:.3e}' for k_, e_ in worst.items()} }, fp32 route "
        f"{ {k_: f'{e_:.3e}' for k_, e_ in worst_fp32.items()} }")
    log(f"[evo_kernels] launches by route (bf16 / fp16 on the tensor cores, fp32 on the "
        f"'_fp32' CUDA-core kernels): {routes} (expected {expected})")
    if routes != expected:
        failures.append(f"launches by route {routes} != expected {expected}")
    new = ("evo_fwd_mma_kernel", "evo_bwd_dq_mma_kernel")
    log("[evo_kernels] tensor-core kernels, ptxas registers and spills:")
    _log_ptxas(tev.kernel_build().ptxas, "[evo_kernels]",
               new + ("evo_bwd_dkdv_mma_kernel", "evo_bwd_db2_mma_kernel", "evo_db2_sum_kernel"))
    # the forward's and dq's tensor-core kernels at d 32 (template argument
    # ILi32E in the mangled name) must not spill
    entries = _ptxas_entries(tev.kernel_build().ptxas, new)
    d32 = {n: e for n, e in entries.items() if "ILi32E" in n}
    if len(d32) != 4 or any(e[1] or e[2] for e in d32.values()):
        failures.append(f"the d 32 tensor-core forward / dq kernels: {d32} (4 kernels, no spill "
                        f"expected)")
    log(f"[evo_kernels] d 32 forward / dq on the tensor cores, registers / spill stores / loads "
        f"(bytes): {sorted(d32.values())}; rows n a CTA at d 32: "
        f"{tev.kernel_build().lib.ds_evo_smem_bytes(6, 32)} B forward, "
        f"{tev.kernel_build().lib.ds_evo_smem_bytes(7, 32)} B dq of shared memory")

    # the main shape: MSA row attention with the pair bias at AlphaFold's
    # fine-tuning crop (the path's largest call with both biases), on both
    # routes: bf16 (the path's) and the same values in fp32
    name0, n_seq, R, h, _ = EVO_CALLS[0]
    N, G, d = n_seq, 1, EVO_D
    q, k, v, do, b1, b2, _ = _evo_case(17, N, G, R, h, d, torch.bfloat16, True, True)
    got = _evo_all(tev, q, k, v, do, b1, b2)
    errs = check(f"main {name0} N={N} R={R} h={h} d={d} bf16", got, q, k, v, do, b1, b2)
    n_chunks = tev.db2_row_chunks(N // G, R, h, G)
    log(f"[evo_kernels] main shape: db2 in {n_chunks} row chunks of {N // G // n_chunks}-"
        f"{-(-(N // G) // n_chunks)} rows, {((R + 63) // 64)**2 * h * G * n_chunks} CTAs, "
        f"scratch {n_chunks * G * h * R * R * 4 / 1e6:.1f} MB")
    out, lse = got[0], got[1]
    del got
    ms, plain_fwd, plain_bwd, lib_fwd, lib_bwd, lib_note, lib_err = _evo_main_times(
        tev, q, k, v, do, b1, b2, out, lse)
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    del q, k, v, do, out, lse
    got = _evo_all(tev, q32, k32, v32, do32, b1, b2)
    errs32 = check(f"main {name0} N={N} R={R} h={h} d={d} fp32", got, q32, k32, v32, do32, b1, b2)
    out32, lse32 = got[0], got[1]
    del got
    ms32, plain_fwd32, plain_bwd32, lib_fwd32, lib_bwd32, _, _ = _evo_main_times(
        tev, q32, k32, v32, do32, b1, b2, out32, lse32)
    del q32, k32, v32, do32, out32, lse32
    spec = _evo_bytes_flops(N, G, R, h, d)
    spec32 = _evo_bytes_flops(N, G, R, h, d, elem=4)
    res = {}
    for name in EVO_KERNELS:
        lib_name = ("SDPA forward, bias1 + bias2 as a float mask in q's dtype"
                    if name == "evo_fwd" else lib_note + " (all five kernels' work together)")
        for sfx, n_bytes_flops, t_ms, pf, pb, lf, lb, peak, err in (
                ("", spec[name], ms, plain_fwd, plain_bwd, lib_fwd, lib_bwd, BF16_FLOPS_PER_S,
                 worst[name]),
                ("_fp32", spec32[name], ms32, plain_fwd32, plain_bwd32, lib_fwd32, lib_bwd32,
                 FP32_FLOPS_PER_S, worst_fp32[name])):
            n_bytes, flops = n_bytes_flops
            b_ms, b_by = bound_ms(n_bytes, flops, peak)
            m = dict(err=err, ms=t_ms[name], plain_ms=pf if name == "evo_fwd" else pb,
                     bound_ms=b_ms, bound_by=b_by, library_ms=lf if name == "evo_fwd" else lb,
                     library=lib_name)
            if sfx:
                res[name]["fp32_route"] = m
            else:
                res[name] = m
            log(f"[evo_kernels] {name}{sfx} {name0} N={N} R={R} h={h} d={d} "
                f"{'fp32' if sfx else 'bf16'}: {m['ms']:.4f} ms, plain {m['plain_ms']:.3f} ms "
                f"({'forward' if name == 'evo_fwd' else 'whole backward'}), bound "
                f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP), "
                f"library {m['library_ms']:.4f} ms")
    for sfx, t_ms in (("", ms), ("_fp32", ms32)):
        adds = t_ms["evo_bwd_db1"] - t_ms["evo_bwd_dkdv"]
        for name in ("evo_bwd_db1", "evo_bwd_dkdv"):
            (res[name]["fp32_route"] if sfx else res[name])["db1_adds_ms"] = adds
        log(f"[evo_kernels] dk/dv{sfx} with the db1 sum {t_ms['evo_bwd_db1']:.4f} ms, without "
            f"{t_ms['evo_bwd_dkdv']:.4f} ms: db1 adds {adds:.4f} ms")
    log(f"[evo_kernels] library: SDPA forward {lib_fwd:.4f} ms bf16 / {lib_fwd32:.4f} ms fp32 "
        f"(max |sdpa - kernel| {lib_err:.3e}, bf16), {lib_note} {lib_bwd:.4f} / "
        f"{lib_bwd32:.4f} ms")
    log(f"[evo_kernels] main-shape max_abs_err: bf16 { {k_: f'{e_:.3e}' for k_, e_ in errs.items()} }"
        f", fp32 { {k_: f'{e_:.3e}' for k_, e_ in errs32.items()} }")
    log(f"[evo_kernels] largest error over all cases {worst_frac[0]:.3f} of its tolerance "
        f"({worst_frac[1]})")
    log(f"[evo_kernels] worst_error_fraction={worst_frac[0]:.6g}")
    if failures:
        raise RuntimeError("Evoformer kernels disagree with the plain version: "
                           + "; ".join(failures[:10]))
    return res


# ---------------------------------------------------------------------------
# phase: one Evoformer block's four attention calls, forward and backward,
# through DS4Sci_EvoformerAttention
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_evoformer(tev):
    """Within the block, the Evoformer Function's kernel wrappers are the
    plain versions, on any device."""
    names = ("evo_fwd", "evo_bwd_dq", "evo_bwd_dkdv", "evo_bwd_db2")
    saved = {n: getattr(tev, n) for n in names}
    tev.evo_fwd = tev.evo_attention_reference
    tev.evo_bwd_dq = lambda *a: tev.evo_attention_reference_bwd(*a)[0]
    tev.evo_bwd_dkdv = lambda *a: tev.evo_attention_reference_bwd(*a)[1:4]
    tev.evo_bwd_db2 = lambda *a: tev.evo_attention_reference_bwd(*a)[4]
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(tev, n, fn)


def _evo_block_inputs(seed):
    """The four calls' inputs: bf16 q/k/v and dout, fp32 biases (both
    trainable), the MSA mask padding the last 10% of residues and a few MSA
    rows (from a seeded generator), OpenFold's mask bias 1e9 (mask - 1)
    and dout 0 on the fully masked rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    S, R = EVO_SEQ, EVO_RES
    msa_mask = torch.ones(S, R, device="cuda")
    msa_mask[:, R - R // 10:] = 0.0
    msa_mask[torch.randperm(S, generator=gen, device="cuda")[:4]] = 0.0
    res_mask = msa_mask.amax(0)
    pair_mask = res_mask[:, None] * res_mask[None, :]
    masks = {"msa_row": msa_mask, "msa_col": msa_mask.t(), "tri_start": pair_mask,
             "tri_end": pair_mask.t()}
    calls = []
    for name, n_seq, r, h, pair in EVO_CALLS:
        mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
        q, k, v, do = (mk(1, n_seq, r, h, EVO_D).to(torch.bfloat16) for _ in range(4))
        m = masks[name].contiguous()
        b1 = (EVO_MASK_INF * (m - 1.0))[None, :, None, None, :].contiguous()
        b2 = mk(1, 1, h, r, r) if pair else None
        full = m.sum(-1) == 0  # [n_seq] rows whose every key is masked
        do[:, full] = 0
        calls.append((name, [q, k, v], [b for b in (b1, b2) if b is not None], do, full))
    return calls


def _evo_block(ds4sci, calls):
    """One block's four calls, forward and backward; returns the outputs
    and every gradient (q, k, v, then the biases) of each call."""
    res = []
    for _, qkv, biases, do, _ in calls:
        leaves = [t.detach().requires_grad_() for t in qkv + biases]
        out = ds4sci(*leaves[:3], leaves[3:])
        out.backward(do)
        res.append((out.detach(), [t.grad for t in leaves]))
    return res


def phase_evo_path():
    """Returns the launches on the path and the block's measurements."""
    import gc

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.accelerator import get_accelerator
    from deepspeed_tpu_torch.ops import evoformer_attention as tev
    from deepspeed_tpu_torch.ops.evoformer_attn import DS4Sci_EvoformerAttention

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    acc = get_accelerator()
    mod = acc.create_op_builder("EvoformerAttnBuilder").load()
    if mod is not tev or acc.device_name() != "cuda":
        raise RuntimeError(f"EvoformerAttnBuilder loaded {mod} on {acc.device_name()}, not the "
                           f"port's evoformer_attention module on cuda")
    calls = _evo_block_inputs(23)
    log(f"[evo_path] AlphaFold-2 fine-tuning crop (N_res {EVO_RES}, N_clust {EVO_SEQ}), "
        f"OpenFold's Evoformer heads: " + "; ".join(
            f"{n} q/k/v {list(qkv[0].shape)} biases {[list(b.shape) for b in bs]}, "
            f"{int(full.sum())} fully masked rows" for n, qkv, bs, _, full in calls))
    log(f"[evo_path] EvoformerAttnBuilder -> {mod.__name__} via {type(acc).__name__}")
    _evo_block(DS4Sci_EvoformerAttention, calls)  # warm
    torch.cuda.synchronize()
    tev.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(EVO_ITERS):
        ts = time.perf_counter()
        kern = _evo_block(DS4Sci_EvoformerAttention, calls)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - ts)
    launches = dict(tev.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_pair = sum(1 for c in EVO_CALLS if c[4])
    # bf16 throughout: every kernel on the tensor cores, none on the fp32
    # route
    expected = dict.fromkeys(tev.launch_counts, 0) | {
        "evo_fwd": 4 * EVO_ITERS, "evo_bwd_dq": 4 * EVO_ITERS, "evo_bwd_dkdv": 4 * EVO_ITERS,
        "evo_bwd_db1": 4 * EVO_ITERS, "evo_bwd_db2": n_pair * EVO_ITERS}
    med = float(np.median(times))
    log(f"[evo_path] block forward + backward (4 calls) median {1e3 * med:.2f} ms (range "
        f"{1e3 * min(times):.2f}-{1e3 * max(times):.2f}); peak memory {peak / 2**30:.2f} GiB "
        f"({(peak - base) / 2**30:.2f} GiB above the inputs)")
    log(f"[evo_path] kernel launches over {EVO_ITERS} blocks: {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError(f"kernel launches {launches} != expected {expected}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ts = time.perf_counter()
        _evo_block(DS4Sci_EvoformerAttention, calls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - ts
    by_name = _device_ms_by_name(prof)
    busy = sum(by_name.values())
    log(f"[evo_path] profiled block: wall {1e3 * wall:.2f} ms, device busy {busy:.2f} ms: idle "
        f"{100 * (1 - busy / (1e3 * wall)):.1f}%")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for name, t in top:
        log(f"[evo_path]   {t:9.3f} ms  {100 * t / busy:5.1f}%  {name[:90]}")
    del prof

    # the same block through the plain versions: output (finite on fully
    # masked rows) and every gradient, relative L2
    with plain_evoformer(tev):
        plain = _evo_block(DS4Sci_EvoformerAttention, calls)
    torch.cuda.synchronize()
    worst_rel, failures = 0.0, []
    for (name, _, biases, _, full), (o_k, g_k), (o_r, g_r) in zip(calls, kern, plain):
        if not bool(torch.isfinite(o_k).all()):
            failures.append(f"{name}: non-finite output")
        pairs = [("out", o_k[:, ~full], o_r[:, ~full])] + list(zip(
            ("dq", "dk", "dv", "dbias1", "dbias2"), g_k, g_r))
        rels = {}
        for gname, a, b in pairs:
            rel = float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
            rels[gname] = rel
            worst_rel = max(worst_rel, rel)
            if not rel <= EVO_PATH_REL_L2_TOL:
                failures.append(f"{name} {gname}: relative L2 {rel:.3e}")
        log(f"[evo_path] {name}, kernels vs plain: relative L2 "
            f"{ {k_: f'{v_:.2e}' for k_, v_ in rels.items()} }")
    log(f"[evo_path] largest relative L2 {worst_rel:.3e} (tolerance {EVO_PATH_REL_L2_TOL})")
    if failures:
        raise RuntimeError("Evoformer path disagrees with the plain path: " + "; ".join(failures))
    block = dict(block_ms=1e3 * med, peak_gib=peak / 2**30, device_busy_ms=busy,
                 worst_rel_l2=worst_rel, top_device_ops=[(n[:60], round(t, 3)) for n, t in top[:5]])
    del calls, kern, plain
    gc.collect()
    torch.cuda.empty_cache()
    return launches, block


# ---------------------------------------------------------------------------
# phase: init_inference and the v1 KV-cache engine on the paged kernels
# ---------------------------------------------------------------------------

def _v1_kernel_checks(pa):
    """The paged kernels at the v1 path's layout (block 128, identity
    tables, Mistral's 32 / 8 heads, d 128) against the plain version: the
    prefills and decodes of both v1 waves and of the hybrid phase's rollout,
    each decode with the split count the dispatcher resolves and at one
    split. Returns {kernel: measurement} of the 8 x 1024 wave."""
    import torch

    from deepspeed_tpu_torch.models.transformer import V1_BLOCK

    nkv, g, d, bs = 8, 4, 128, V1_BLOCK
    nq = nkv * g
    failures, res = [], {}
    worst = [0.0]

    def case(seed, B, smax, seq, pos):
        nb = smax // bs
        tables = (torch.arange(B, dtype=torch.int32)[:, None] * nb
                  + torch.arange(nb, dtype=torch.int32)[None, :])
        return _make_case(seed, nkv, g, d, bs, tables, seq, pos, False)

    def check(tag, out, q, k, v, tb, si, po, chunk=256):
        # the plain version gathers each token's whole context: in chunks of tokens
        ref = torch.cat([pa.paged_attention_reference(q[c:c + chunk], k, v, tb, si[c:c + chunk],
                                                      po[c:c + chunk], bs)
                         for c in range(0, q.shape[0], chunk)])
        e, frac = _err(out, ref)
        worst[0] = max(worst[0], frac)
        if not frac <= 1.0:
            failures.append(f"{tag}: max_abs_err {e:.3e}, {frac:.2f}x its tolerance")
        return e

    for B, S, new in (*V1_WAVES, (*HYBRID_PROMPT, HYBRID_NEW)):
        smax = -(-(S + new) // bs) * bs
        nb = smax // bs
        # the prefill: B prompts of S tokens from position 0
        seq = torch.arange(B, dtype=torch.int32).repeat_interleave(S)
        pos = torch.arange(S, dtype=torch.int32).repeat(B)
        q, k, v, tb, si, po, _ = case(B + S, B, smax, seq, pos)
        T = q.shape[0]
        if pa.resolve_q_tile(T, B) == 1:
            raise RuntimeError(f"{B} x {S} tokens would not take the prefill route")
        fn = lambda: pa.paged_prefill(q, k, v, tb, si, po, bs)  # noqa: E731
        e = check(f"paged_prefill B={B} S={S} block {bs}", fn(), q, k, v, tb, si, po)
        n_bytes = 2 * T * nq * d * 2 + T * nkv * 2 * d * 2 + 2 * T * 4
        b_ms, b_by = bound_ms(n_bytes, 4 * nq * d * B * (S * (S + 1) // 2))
        res[("paged_prefill", B, S)] = dict(err=e, ms=time_ms(fn, iters=10, warmup=2),
                                         device_ms=queued_ms(fn, iters=10), bound_ms=b_ms,
                                         bound_by=b_by, tokens=T)
        # the decode: one token a sequence at the wave's last position
        seq = torch.arange(B, dtype=torch.int32)
        pos = torch.full((B, ), S + new - 1, dtype=torch.int32)
        q, k, v, tb, si, po, _ = case(B + new, B, smax, seq, pos)
        splits = pa.resolve_kv_splits(B, B, nb)
        ctx = S + new
        n_bytes = 2 * B * nq * d * 2 + B * ctx * nkv * 2 * d * 2 + tb.numel() * 4 + 2 * B * 4
        b_ms, b_by = bound_ms(n_bytes, 4 * nq * d * B * ctx)
        for ks in sorted({1, splits}):
            name = "paged_decode" if ks == 1 else "paged_decode_split"
            fn = lambda ks=ks: pa.paged_decode(q, k, v, tb, si, po, bs, kv_splits=ks)  # noqa: E731
            e = check(f"{name} B={B} Smax={smax} splits={ks} block {bs}", fn(), q, k, v, tb, si,
                      po)
            res[(name, B, S)] = dict(err=e, ms=time_ms(fn), device_ms=queued_ms(fn),
                                  bound_ms=b_ms, bound_by=b_by, splits=ks, context=ctx)
        log(f"[v1] block {bs}, wave B={B} x S={S} (+{new}, Smax {smax}, {nb} blocks a table, "
            f"the dispatcher's splits {splits}): "
            + "; ".join(f"{n} {m['ms']:.4f} ms, {m['device_ms']:.4f} with the host queued ahead "
                        f"(bound {m['bound_ms']:.4f}, {m['bound_by']}), max_abs_err "
                        f"{m['err']:.3e}" for (n, b, s), m in res.items() if (b, s) == (B, S)))
    log(f"[v1] block-{bs} kernel checks: largest error {worst[0]:.3f} of its tolerance "
        f"({TOL_ULPS} bf16 ulp + 2^-14); worst_error_fraction={worst[0]:.6g}")
    if failures:
        raise RuntimeError("v1 kernels disagree with the plain version: " + "; ".join(failures))
    big = V1_WAVES[-1][:2]
    return {n: m for (n, b, s), m in res.items() if (b, s) == big}


def _generate_ms(engine, prompt, new, repeats=3):
    """Median wall (synchronised: the tokens come back to the host) of
    ``engine.generate(prompt, new)`` over ``repeats`` calls, in ms."""
    import numpy as np

    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=new)
        walls.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(walls))


def _profiled_generate(engine, prompt, new):
    """(device busy ms, wall ms) of one ``generate`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(prompt, max_new_tokens=new)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    return sum(_device_ms_by_name(prof).values()), wall


def _route_parity(tag, cfg, params, prompt, new):
    """Last-token logits of the paged route (``cfg``) against the dense
    route (``attention_impl="reference"``) on the same weights, after a
    prefill of ``prompt`` [B, S] and after one decode step that feeds both
    the paged route's greedy token, in a cache of S + ``new`` rounded up to
    a block, as ``generate`` allocates it. Logs and returns [(rel L2,
    argmax agreement)] of the two."""
    import dataclasses

    import torch

    from deepspeed_tpu_torch.models.transformer import V1_BLOCK, forward_with_cache, init_kv_cache

    B, S = prompt.shape
    smax = -(-(S + new) // V1_BLOCK) * V1_BLOCK
    ids, tok, pair = torch.from_numpy(prompt), None, []
    with torch.no_grad():
        for c in (cfg, dataclasses.replace(cfg, attention_impl="reference")):
            cache = init_kv_cache(c, B, smax)
            first, cache = forward_with_cache(c, params, ids, cache)
            tok = torch.argmax(first[:, -1:], dim=-1) if tok is None else tok
            second, _ = forward_with_cache(c, params, tok, cache)
            pair.append((first[:, -1], second[:, -1]))
    (pk, dk), (pd, dd) = pair
    if not all(bool(torch.isfinite(x).all()) for x in (pk, dk)):
        raise RuntimeError(f"{tag}: non-finite logits through the kernels")
    rows = []
    for what, a, b in (("prefill", pk, pd), ("decode", dk, dd)):
        rel = float((a - b).norm() / b.norm())
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        rows.append((rel, same))
        log(f"{tag} {what} last-token logits, paged kernels vs the dense route: rel L2 "
            f"{rel:.3e} (tolerance {LOGITS_REL_L2_TOL}); argmax agrees on {100 * same:.0f}% of "
            f"rows")
    return rows


def phase_v1():
    """Returns the launches on the v1 path and its measurements."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import mistral
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import paged_attention as pa

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    kernels = _v1_kernel_checks(pa)
    log(f"[v1] kernel checks done at {time.perf_counter() - t_phase:.1f}s")

    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(mistral("7b", seed=0),
                                                config={"dtype": "bfloat16"})
    torch.cuda.synchronize()
    mc = engine.model_config
    log(f"[v1] Mistral-7B through init_inference: {mc.num_layers} layers, hidden "
        f"{mc.hidden_size}, heads {mc.num_heads}/{mc.num_kv_heads}, "
        f"{engine.module.num_params() / 1e9:.3f}B params, bf16, built in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mc.vocab_size, (B, S)).astype(np.int32) for B, S, _ in V1_WAVES]
    fwd_ids = rng.integers(0, mc.vocab_size, V1_FORWARD).astype(np.int32)

    # the main path: both waves' generate, then one forward
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    outs, cold = [], []
    for prompt, (B, S, new) in zip(prompts, V1_WAVES):
        t0 = time.perf_counter()
        outs.append(engine.generate(prompt, max_new_tokens=new))
        cold.append(time.perf_counter() - t0)
    logits = engine.forward(fwd_ids)
    torch.cuda.synchronize()
    launches = {**pa.launch_counts, "flash_fwd": fa.launch_counts["flash_fwd"]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for out, prompt, (B, S, new) in zip(outs, prompts, V1_WAVES):
        if (out.shape != (B, S + new) or not (out[:, :S] == prompt).all()
                or not ((0 <= out) & (out < mc.vocab_size)).all()):
            raise RuntimeError(f"wave {B} x {S}: bad generation, shape {out.shape}")
    if (tuple(logits.shape) != (*V1_FORWARD, mc.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"forward: bad logits {tuple(logits.shape)}")
    log(f"[v1] main path: generate {[f'{B} x {S} + {n}' for B, S, n in V1_WAVES]} in "
        f"{[round(1e3 * c, 1) for c in cold]} ms (first calls), forward {list(V1_FORWARD)}; "
        f"peak memory {peak:.2f} GiB")
    log(f"[v1] kernel launches on the main path: {launches}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernel paths never launched on the v1 path: {missing}")

    log(f"[v1] main path done at {time.perf_counter() - t_phase:.1f}s")
    # warmed times: prefill (generate of one token) and decode per step
    waves = []
    for prompt, (B, S, new) in zip(prompts, V1_WAVES):
        pre = _generate_ms(engine, prompt, 1)
        full = _generate_ms(engine, prompt, new, repeats=2)
        step = (full - pre) / (new - 1)
        waves.append(dict(batch=B, prompt=S, new=new, prefill_ms=pre, generate_ms=full,
                          decode_ms_per_step=step, decode_tok_s=1e3 * B / step))
        log(f"[v1] wave {B} x {S} + {new}: prefill {pre:.2f} ms (generate of one token, median "
            f"of 3), generate {full:.2f} ms (median of 2), decode {step:.3f} ms/step, "
            f"{1e3 * B / step:.1f} tok/s")
    # the device's idle share over a decode stretch of the larger wave
    B, S, _ = V1_WAVES[-1]
    new = 1 + V1_PROFILE_STEPS
    busy_1, wall_1 = _profiled_generate(engine, prompts[-1], 1)
    busy_n, wall_n = _profiled_generate(engine, prompts[-1], new)
    busy = (busy_n - busy_1) / (new - 1)
    wall = (wall_n - wall_1) / (new - 1)
    step = waves[-1]["decode_ms_per_step"]
    log(f"[v1] decode profile, {B} sequences x {new - 1} steps from position {S} (the "
        f"difference of two profiled generates, {new} tokens and 1): device busy {busy:.3f} "
        f"ms/step, wall {wall:.3f} "
        f"ms/step profiled, {step:.3f} unprofiled: device idle {100 * (1 - busy / step):.1f}% "
        f"of the unprofiled wall, {100 * (1 - busy / wall):.1f}% of the profiled one")

    log(f"[v1] timings and profile done at {time.perf_counter() - t_phase:.1f}s")
    # parity: last-token logits, kernels vs the dense route on the same
    # weights, after a prefill and one decode step
    rows = [r for prompt, (B, S, new) in zip(prompts, V1_WAVES)
            for r in _route_parity(f"[v1] wave {B} x {S}", mc, engine.params, prompt, new)]
    rels, agree = [r for r, _ in rows], [a for _, a in rows]
    worst_rel = max(rels)
    log(f"[v1] largest logits rel L2 {worst_rel:.3e}; worst_error_fraction="
        f"{worst_rel / LOGITS_REL_L2_TOL:.6g}")
    if not worst_rel <= LOGITS_REL_L2_TOL:
        raise RuntimeError(f"v1 logits disagree: rel L2 {worst_rel:.3e} > {LOGITS_REL_L2_TOL}")
    del engine, logits
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(kernels_block128=kernels, waves=waves, peak_gib=peak,
                          decode_device_busy_ms=busy, decode_wall_ms=step,
                          logits_rel_l2=worst_rel, argmax_agreement=min(agree))


def phase_hybrid():
    """The hybrid engine (``initialize`` with ``hybrid_engine.enabled``) on
    the ``train`` phase's configuration: generate, generate, train_batch x
    2, generate. Then its rollout's logits against the dense route on the
    same weights, and its generate timed in turns against an engine over
    the live fp32 masters (cast where used).
    Returns the launches and measurements."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.ops import paged_attention as pa

    gc.collect()
    torch.cuda.empty_cache()
    cfg = mistral_config("7b", num_layers=TRAIN_LAYERS)
    model = TransformerLM(cfg, trainable=True, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=HYBRID_DS_CONFIG)
    if not isinstance(engine, deepspeed_tpu_torch.DeepSpeedHybridEngine):
        raise RuntimeError(f"initialize returned {type(engine).__name__}")
    writes = []
    write_view = engine._write_view

    def timed_write():  # each refresh of the view, synchronised and timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_view()
        torch.cuda.synchronize()
        writes.append(1e3 * (time.perf_counter() - t0))

    engine._write_view = timed_write
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, HYBRID_PROMPT).astype(np.int32)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                       (engine.train_batch_size(), TRAIN_SEQ)).astype(np.int32)}
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    fad.reset_launch_counts()
    out1 = engine.generate(prompt, max_new_tokens=HYBRID_NEW)
    out1b = engine.generate(prompt, max_new_tokens=HYBRID_NEW)
    view_wq = engine._inference_engine.params["blocks"][0]["wq"]
    wq_before = view_wq.clone()
    losses = [float(engine.train_batch(batch)) for _ in range(2)]
    out2 = engine.generate(prompt, max_new_tokens=HYBRID_NEW)
    torch.cuda.synchronize()
    launches = {**pa.launch_counts, **fa.launch_counts, **fad.launch_counts}
    latency = engine.generate_latency()
    changed = float((view_wq != wq_before).float().mean())
    log(f"[hybrid] Mistral-7B width, {TRAIN_LAYERS} layers, fp32 masters -> a bf16 view of "
        f"{sum(v.numel() * v.element_size() for v, _ in engine._view_pairs) / 2**30:.2f} GiB "
        f"({len(engine._view_pairs)} slots); generate {list(HYBRID_PROMPT)} + "
        f"{HYBRID_NEW}, generate, train_batch x 2 (losses {[round(x, 5) for x in losses]}), "
        f"generate")
    log(f"[hybrid] view writes {len(writes)} ({[round(w, 2) for w in writes]} ms; the first "
        f"at build), steps {engine._inference_params_step}, train mode after generate "
        f"{engine._train_mode}; generate {[round(1e3 * s, 1) for s in latency]} ms; "
        f"{100 * changed:.1f}% of layer 0's bf16 wq changed after the steps; rollouts before / "
        f"after the steps equal: {bool(np.array_equal(out1, out2))}")
    log(f"[hybrid] kernel launches: {launches}")
    # the rollout's weights through the dense route
    ie = engine._inference_engine
    rows = _route_parity("[hybrid] after two steps,", ie.model_config, ie.params, prompt,
                         HYBRID_NEW)
    worst_rel = max(r for r, _ in rows)
    # the engine's bf16 view against the live fp32 masters cast at every
    # use (what the view costs and saves), in turns
    engines = {"view": ie, "masters": InferenceEngine(model, engine._inference_config(),
                                                      params=engine.module.params())}
    same = bool(np.array_equal(engines["masters"].generate(prompt, max_new_tokens=HYBRID_NEW),
                               out2))
    turns = {k: [] for k in engines}
    for k in ("view", "masters", "masters", "view"):
        turns[k].append(_generate_ms(engines[k], prompt, HYBRID_NEW))
    busy = {k: _profiled_generate(e, prompt, HYBRID_NEW)[0] for k, e in engines.items()}
    log(f"[hybrid] generate {list(HYBRID_PROMPT)} + {HYBRID_NEW} in turns (median of 3 each; "
        f"device busy of one profiled call): " + "; ".join(
            f"{k} {[round(t, 2) for t in turns[k]]} ms, busy {busy[k]:.2f} ms" for k in engines)
        + f"; the masters' rollout equals the view's: {same}")
    del engines
    failures = []
    if not worst_rel <= LOGITS_REL_L2_TOL:
        failures.append(f"rollout logits rel L2 {worst_rel:.3e} > {LOGITS_REL_L2_TOL} against "
                        f"the dense route")
    if len(writes) != 2 or engine._inference_params_step != 2 or int(engine.state["step"]) != 2:
        failures.append(f"view written {len(writes)} times (expected 2: at build and after the "
                        f"step counter moved), at step {engine._inference_params_step}")
    if not changed > 0:
        failures.append("the view's wq did not change after two steps")
    if not engine._train_mode:
        failures.append("generate did not restore the train mode")
    if not np.array_equal(out1, out1b):
        failures.append("greedy rollouts on the same weights differ")
    for out in (out1, out2):
        if out.shape != (HYBRID_PROMPT[0], HYBRID_PROMPT[1] + HYBRID_NEW) or not (
                (0 <= out) & (out < cfg.vocab_size)).all():
            failures.append(f"bad rollout {out.shape}")
    if not all(np.isfinite(losses)):
        failures.append(f"losses {losses}")
    for key in ("paged_prefill", "paged_decode", "flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                "fused_adam"):
        if launches[key] <= 0:
            failures.append(f"{key} never launched")
    if failures:
        raise RuntimeError("hybrid engine: " + "; ".join(failures))
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(view_write_ms=writes, generate_ms=[1e3 * s for s in latency],
                          losses=losses, wq_changed_fraction=changed, logits_rel_l2=worst_rel,
                          generate_in_turns_ms=turns, generate_busy_ms=busy)


# ---------------------------------------------------------------------------
# phase 19: sampled decoding and the prefix cache with its host tier
# ---------------------------------------------------------------------------

def _drain_tier(pc, tier, deadline_s=60.0):
    """Wait until the migration queue is empty and no node is in flight."""
    from deepspeed_tpu_torch.inference.v2.ragged.tiered_store import RES_IN_FLIGHT

    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        with pc._tree_lock:
            busy = tier.queued or any(n.res == RES_IN_FLIGHT for n in pc._iter_nodes())
        if not busy:
            return
        time.sleep(0.01)
    raise RuntimeError(f"the host tier did not drain within {deadline_s}s")


def _prefix_wave(engine, prompts, knobs, after_first=None, after_admit=None):
    """One wave through a fresh scheduler: request 0 alone until its first
    token (its blocks are then in the tree), then the others together.
    Returns (results, time to first token per uid in s, the scheduler's
    stats)."""
    import torch

    from deepspeed_tpu_torch.inference.v2 import DynamicSplitFuseScheduler

    sched = DynamicSplitFuseScheduler(engine)
    submitted, ttft = {}, {}

    def step():
        if sched.step() == 0:
            raise RuntimeError("scheduler stalled")
        now = time.perf_counter()
        for uid, toks in sched.results.items():
            if toks and uid not in ttft:
                ttft[uid] = now - submitted[uid]

    def submit(uid):
        sched.submit(uid, prompts[uid], max_new_tokens=PREFIX_NEW, sampling=knobs[uid])
        submitted[uid] = time.perf_counter()

    submit(0)
    while 0 not in ttft:
        step()
    if after_first is not None:
        after_first()
    for uid in range(1, len(prompts)):
        submit(uid)
    step()  # admits every other request: the hits and their copy-on-write
    if after_admit is not None:
        after_admit()
    while sched.has_work:
        step()
    torch.cuda.synchronize()
    return sched.results, ttft, dict(sched.stats)


def phase_prefix_sample():
    """Mistral-7B at full width and depth with the prefix cache and a host
    tier, sampled and greedy requests through the scheduler; the checks of
    the module docstring. Returns the launches of its two counted runs (the
    wave and the short-context wave) and its record."""
    import gc
    import zlib

    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig, HostTierConfig,
                                                  InferenceEngineV2, PrefixCacheConfig,
                                                  RaggedInferenceEngineConfig, SamplingParams,
                                                  build_model_engine)
    from deepspeed_tpu_torch.inference.v2 import sampling as smp
    from deepspeed_tpu_torch.ops import paged_attention as pa

    gc.collect()
    torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    def config(cache_on, blocks, max_context=2048, host_tier=True):
        tier = HostTierConfig(host_blocks=PREFIX_HOST_BLOCKS, queue_depth=PREFIX_HOST_BLOCKS)
        return RaggedInferenceEngineConfig(
            kv_block_size=64, num_kv_blocks=blocks,
            state_manager=DSStateManagerConfig(max_context=max_context,
                                               max_ragged_batch_size=PREFIX_BATCH),
            prefix_cache=PrefixCacheConfig(enabled=cache_on,
                                           host_tier=tier if cache_on and host_tier else None))

    t0 = time.perf_counter()
    engine = build_model_engine("mistral", "7b", config(True, PREFIX_POOL_BLOCKS), seed=0)
    torch.cuda.synchronize()
    mc, bs = engine.model_config, 64
    vocab = mc.vocab_size
    kv, pc, tier = engine.state_manager.kv_cache, engine.prefix_cache, engine.tiered_store
    log(f"[prefix_sample] {smi}; Mistral-7B {mc.num_layers} layers, KV pool "
        f"{PREFIX_POOL_BLOCKS} x {bs} slots ({kv.memory_bytes() / 2**30:.2f} GiB), host tier "
        f"{PREFIX_HOST_BLOCKS} blocks ({tier.pool.memory_bytes() / 2**30:.2f} GiB pinned), built "
        f"in {time.perf_counter() - t0:.1f}s")

    rng = np.random.default_rng(19)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).astype(np.int32)
    suffixes = [rng.integers(0, vocab, int(n)).astype(np.int32)
                for n in rng.integers(64, 201, PREFIX_REQUESTS)]
    prompts = [np.concatenate([system, s]) for s in suffixes]
    prompts[5] = np.concatenate([system[:PREFIX_SPLIT], suffixes[5]])  # leaves mid-block 15
    prompts[7] = prompts[0].copy()  # an exact repeat
    knobs = [SamplingParams(**PREFIX_KNOBS, seed=1000 + u) if u % 2 == 0 else None
             for u in range(PREFIX_REQUESTS)]
    n_sys = PREFIX_SYSTEM // bs

    def gather(blocks):  # device copies of the blocks' K and V, every layer
        idx = torch.as_tensor([b * bs + i for b in blocks for i in range(bs)], device=kv.device)
        return kv.k_pool.index_select(1, idx), kv.v_pool.index_select(1, idx)

    def crc(pair):
        return zlib.crc32(b"".join(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                   for t in pair)) & 0xFFFFFFFF

    record, failures, seen = {"card": smi}, [], {}

    def after_first():  # the system prompt's blocks, before any hit reads them
        seen["system_blocks"] = list(engine.query(0).kv_blocks[:n_sys])
        seen["system_kv"] = gather(seen["system_blocks"])
        seen["crc_before"] = crc(seen["system_kv"])

    def after_admit():  # request 5's copy-on-write tail against its source
        src, cow = engine.query(0).kv_blocks[n_sys - 1], engine.query(5).kv_blocks[n_sys - 1]
        kept = PREFIX_SPLIT - (n_sys - 1) * bs
        span = lambda b: slice(b * bs, b * bs + kept)  # noqa: E731
        seen["cow"] = (src, cow, kept, cow != src
                       and torch.equal(kv.k_pool[:, span(cow)], kv.k_pool[:, span(src)])
                       and torch.equal(kv.v_pool[:, span(cow)], kv.v_pool[:, span(src)]),
                       kv.refcount(src))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    t_wave = time.perf_counter()
    results, ttft, sched_stats = _prefix_wave(engine, prompts, knobs, after_first, after_admit)
    wave_s = time.perf_counter() - t_wave
    wave_launches = dict(pa.launch_counts)
    stats = dict(pc.stats)
    skipped = sched_stats["prefill_tokens_skipped"]
    for uid in range(PREFIX_REQUESTS):
        toks = results.get(uid)
        if toks is None or len(toks) != PREFIX_NEW or not all(0 <= t < vocab for t in toks):
            failures.append(f"request {uid}: bad generation {toks}")
    after = gather(seen["system_blocks"])
    unchanged = all(torch.equal(a, b) for a, b in zip(after, seen["system_kv"]))
    crc_after = crc(after)
    still_cached = set(seen["system_blocks"]) <= set(pc.cached_block_ids())
    src, cow, kept, cow_equal, src_refs = seen["cow"]
    ttft_ms = {u: round(1e3 * t, 2) for u, t in sorted(ttft.items())}
    log(f"[prefix_sample] wave: {PREFIX_REQUESTS} requests x {PREFIX_NEW} tokens in "
        f"{wave_s:.2f}s; prefix hits {stats['hits']} of {stats['lookups']} lookups, "
        f"prefill tokens skipped {skipped}, cached tokens {stats['cached_tokens']}, "
        f"copy-on-write copies {stats['cow_copies']} ({stats['cow_bytes']} bytes); TTFT ms "
        f"{ttft_ms} (request 0 cold, alone; the others admitted together)")
    log(f"[prefix_sample] the system prompt's {n_sys} shared blocks: crc32 {seen['crc_before']:#010x} "
        f"before the hits, {crc_after:#010x} after the wave, bytes equal: {unchanged}, still "
        f"in the tree: {still_cached}; request 5's copy-on-write block {cow} (source {src}, "
        f"refcount {src_refs} at admission) equals its source's {kept} kept slots: {cow_equal}")
    log(f"[prefix_sample] wave launches: {wave_launches}")
    if stats["hits"] < PREFIX_REQUESTS - 2 or skipped < (PREFIX_REQUESTS - 2) * PREFIX_SYSTEM:
        failures.append(f"hits {stats['hits']}, prefill tokens skipped {skipped}")
    if stats["cow_copies"] < 1 or not cow_equal:
        failures.append(f"copy-on-write: {stats['cow_copies']} copies, block equal {cow_equal}")
    if not (unchanged and still_cached):
        failures.append("the shared system-prompt blocks changed during the wave")
    for key in ("paged_prefill", "paged_decode_split", "paged_decode_merge"):
        if wave_launches[key] <= 0:
            failures.append(f"{key} never launched in the wave")

    # a hit against a cold put on an engine with the cache off sharing the
    # weights: logits and time to first token (each put twice, the second
    # timed; 20 tokens after the hit take the per-token decode kernel)
    probe = np.concatenate([system, rng.integers(0, vocab, 20).astype(np.int32)])
    cold_engine = InferenceEngineV2(engine.module, config(False, 40), params=engine.params)

    def timed_put(eng, uid, prompt=probe):
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = eng.put([uid], [prompt])  # host logits: the wall ends synchronised
        dt = time.perf_counter() - t
        cached = eng.query(uid).prefix_cached_tokens
        eng.flush(uid)
        return logits, dt, cached

    cold = [timed_put(cold_engine, 300 + i) for i in range(2)]
    hit = [timed_put(engine, 300 + i) for i in range(2)]
    logits_cold, logits_hit = cold[1][0], hit[1][0]
    if logits_hit.shape != (1, vocab) or not np.isfinite(logits_hit).all():
        failures.append(f"bad hit logits {logits_hit.shape}")
    rel_hit = float(np.linalg.norm(logits_hit - logits_cold) / np.linalg.norm(logits_cold))
    log(f"[prefix_sample] {probe.size}-token prompt, a hit of {hit[1][2]} tokens against a cold "
        f"put: TTFT {1e3 * hit[1][1]:.2f} ms against {1e3 * cold[1][1]:.2f} ms (first calls "
        f"{1e3 * hit[0][1]:.2f} / {1e3 * cold[0][1]:.2f}); last-token logits rel L2 "
        f"{rel_hit:.3e} (tolerance {LOGITS_REL_L2_TOL}), same argmax "
        f"{int(np.argmax(logits_hit)) == int(np.argmax(logits_cold))}")
    if hit[1][2] != PREFIX_SYSTEM or not rel_hit <= LOGITS_REL_L2_TOL:
        failures.append(f"hit of {hit[1][2]} tokens, logits rel L2 {rel_hit:.3e}")

    # request 5's case held against the cold put: the system prompt left at
    # token 1000 (mid-block), a fresh suffix of request 5's length; the hit
    # copies the shared block's 40 kept slots and the q-tiled prefill starts
    # at position 1000 over the copy
    cow_probe = np.concatenate([system[:PREFIX_SPLIT],
                                rng.integers(0, vocab, suffixes[5].size)]).astype(np.int32)
    cow0 = pc.stats["cow_copies"]
    logits_cow_cold = timed_put(cold_engine, 302, cow_probe)[0]
    logits_cow, _, cached_cow = timed_put(engine, 302, cow_probe)
    cow_new = pc.stats["cow_copies"] - cow0
    rel_cow = float(np.linalg.norm(logits_cow - logits_cow_cold) / np.linalg.norm(logits_cow_cold))
    log(f"[prefix_sample] {cow_probe.size}-token prompt leaving the system prompt at token "
        f"{PREFIX_SPLIT}: a hit of {cached_cow} tokens with {cow_new} copy-on-write copy; "
        f"last-token logits against a cold put rel L2 {rel_cow:.3e} (tolerance "
        f"{LOGITS_REL_L2_TOL}), same argmax "
        f"{int(np.argmax(logits_cow)) == int(np.argmax(logits_cow_cold))}")
    if (cached_cow != PREFIX_SPLIT or cow_new != 1 or not np.isfinite(logits_cow).all()
            or not rel_cow <= LOGITS_REL_L2_TOL):
        failures.append(f"copy-on-write hit of {cached_cow} tokens ({cow_new} copies), logits "
                        f"rel L2 {rel_cow:.3e}")

    # demote the whole tree to the host tier, then hit the system prompt
    # again: promoted bit-equal to the pre-demotion copy, logits as cold
    t = time.perf_counter()
    while pc.demote_cold(pc.n_cached_blocks):
        _drain_tier(pc, tier)
    demote_s = time.perf_counter() - t
    m = pc.match(probe)
    host_chain = m.host_blocks
    pw0 = pc.stats["promote_wait_s"]
    logits_prom, put_s, cached_prom = timed_put(engine, 310)
    promote_s = pc.stats["promote_wait_s"] - pw0
    seq_blocks = pc.match(probe).shared_blocks[:n_sys]
    promoted = gather(seq_blocks)
    bit_equal = len(seq_blocks) == n_sys and all(torch.equal(a, b) for a, b in
                                                 zip(promoted, seen["system_kv"]))
    rel_prom = float(np.linalg.norm(logits_prom - logits_cold) / np.linalg.norm(logits_cold))
    snap = tier.snapshot()
    log(f"[prefix_sample] demoted the tree ({snap['demotions']} blocks, "
        f"{1e3 * demote_s:.1f} ms to drain); the system prompt's chain on the host "
        f"({host_chain} blocks), then hit: {snap['promotions_host']} blocks promoted in "
        f"{1e3 * promote_s:.2f} ms (the put {1e3 * put_s:.2f} ms, {cached_prom} tokens cached); "
        f"promoted bytes equal the pre-demotion copy: {bit_equal}; logits rel L2 {rel_prom:.3e}")
    if host_chain != n_sys or not bit_equal or not rel_prom <= LOGITS_REL_L2_TOL:
        failures.append(f"promotion: chain {host_chain} on the host, bit-equal {bit_equal}, "
                        f"logits rel L2 {rel_prom:.3e}")
    del cold_engine

    def horizons(eng, uids, prefix, n_suffix):
        """Decode horizons of the uids (each put once on ``prefix`` plus
        ``n_suffix`` fresh tokens), all rows sampled against greedy, in
        turns: wall ms/step of each."""
        firsts = np.concatenate([  # one put each: a put's token budget counts the cached tokens
            eng.put([u], [np.concatenate([prefix, rng.integers(0, vocab, n_suffix)]).astype(
                np.int32)], sample="greedy") for u in uids])
        knobs_all = [SamplingParams(**PREFIX_KNOBS, seed=2000 + i) for i in range(len(uids))]
        ms = {"greedy": [], "sampled": []}
        last = firsts
        for mode in ("greedy", "sampled", "sampled", "greedy"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = eng.decode(uids, [[x] for x in last], PREFIX_DECODE_STEPS,
                             sampling=knobs_all if mode == "sampled" else None)
            ms[mode].append(1e3 * (time.perf_counter() - t) / PREFIX_DECODE_STEPS)
            last = out[:, -1]
        for u in uids:
            eng.flush(u)
        return ms

    uids = list(range(400, 400 + PREFIX_REQUESTS))
    horizon_ms = horizons(engine, uids, system, 90)
    logits8 = torch.randn(len(uids), vocab, device=kv.device)
    rows = [torch.full((len(uids), ), v, device=kv.device) for v in PREFIX_KNOBS.values()]
    seeds8 = torch.arange(len(uids), dtype=torch.int32, device=kv.device)
    sampler_ms = time_ms(lambda: smp.sample_tokens(logits8, *rows, seeds8, seeds8), iters=20)
    log(f"[prefix_sample] decode, {len(uids)} sequences x {PREFIX_DECODE_STEPS} steps, wall "
        f"ms/step: greedy {horizon_ms['greedy']}, sampled {horizon_ms['sampled']} (in turns); "
        f"the sampler alone on [{len(uids)}, {vocab}] logits {sampler_ms:.3f} ms")

    # the sampler's distribution on the card
    dev = kv.device
    row_np = -np.log1p(np.arange(CHI2_VOCAB, dtype=np.float64))[rng.permutation(CHI2_VOCAB)]
    row = torch.as_tensor(row_np, dtype=torch.float32, device=dev)
    chunk = 2000
    temps = torch.full((chunk, ), PREFIX_KNOBS["temperature"], device=dev)
    top_ps = torch.full((chunk, ), PREFIX_KNOBS["top_p"], device=dev)
    seeds = torch.full((chunk, ), 4242, dtype=torch.int32, device=dev)
    draws = torch.cat([
        smp.sample_tokens(row.expand(chunk, CHI2_VOCAB), temps, top_ps, seeds,
                          torch.arange(c, c + chunk, dtype=torch.int32, device=dev))
        for c in range(0, CHI2_DRAWS, chunk)]).cpu().numpy()
    filt = smp._filtered(row[None], temps[:1], top_ps[:1])[0].double().cpu()
    nucleus = torch.isfinite(filt).numpy()
    p = torch.softmax(filt, 0).numpy()
    outside = int((~nucleus[draws]).sum())
    counts = np.bincount(draws, minlength=CHI2_VOCAB)
    top = np.argsort(-p)[:CHI2_TOP]
    rest = np.setdiff1d(np.nonzero(nucleus)[0], top)
    obs = np.append(counts[top], counts[rest].sum()).astype(np.float64)
    exp = np.append(p[top], p[rest].sum()) * CHI2_DRAWS
    chi2 = float(((obs - exp)**2 / exp).sum())
    dof = len(obs) - 1
    p_value = float(torch.special.gammaincc(torch.tensor(dof / 2, dtype=torch.float64),
                                            torch.tensor(chi2 / 2, dtype=torch.float64)))
    log(f"[prefix_sample] sampler on a {CHI2_VOCAB}-entry row: nucleus {int(nucleus.sum())} "
        f"tokens; {CHI2_DRAWS} draws, {outside} outside it; chi-square {chi2:.1f} on {dof} "
        f"degrees of freedom (least expected count {exp.min():.1f}), p = {p_value:.4f} "
        f"(must exceed {CHI2_MIN_P})")
    if outside or not p_value > CHI2_MIN_P:
        failures.append(f"sampler: {outside} draws outside the nucleus, chi-square p {p_value}")

    # the sampled wave replayed on a fresh engine with the same seeds
    replay = InferenceEngineV2(engine.module, config(True, PREFIX_POOL_BLOCKS),
                               params=engine.params)
    results2, _, _ = _prefix_wave(replay, prompts, knobs)
    same = results2 == results
    replay.shutdown()
    del replay
    log(f"[prefix_sample] the wave replayed on a fresh engine: every stream identical: {same} "
        f"(sampled uids {[u for u in range(PREFIX_REQUESTS) if knobs[u] is not None]})")
    if not same:
        failures.append("the replayed wave's streams differ")

    # the short-context wave on an engine sharing the weights (its own tree,
    # no host tier): tables 7 blocks wide, so its horizons, sampled and
    # greedy, take the per-token decode kernel
    short = InferenceEngineV2(engine.module, config(True, PREFIX_SHORT_BLOCKS,
                                                    PREFIX_SHORT_CONTEXT, host_tier=False),
                              params=engine.params)
    system2 = rng.integers(0, vocab, PREFIX_SHORT_SYSTEM).astype(np.int32)
    prompts2 = [np.concatenate([system2, rng.integers(0, vocab, int(n))]).astype(np.int32)
                for n in rng.integers(32, 97, PREFIX_REQUESTS)]
    knobs2 = [SamplingParams(**PREFIX_KNOBS, seed=3000 + u) if u % 2 == 0 else None
              for u in range(PREFIX_REQUESTS)]
    torch.cuda.synchronize()
    pa.reset_launch_counts()
    t = time.perf_counter()
    short_results, _, sched2 = _prefix_wave(short, prompts2, knobs2)
    short_s = time.perf_counter() - t
    short_launches = dict(pa.launch_counts)
    stats2 = dict(short.prefix_cache.stats)
    bad2 = [u for u in range(PREFIX_REQUESTS) if len(short_results.get(u, ())) != PREFIX_NEW
            or not all(0 <= x < vocab for x in short_results[u])]
    short_ms = horizons(short, list(range(500, 500 + PREFIX_REQUESTS)), system2, 44)
    log(f"[prefix_sample] short-context wave (max_context {PREFIX_SHORT_CONTEXT}, "
        f"{PREFIX_REQUESTS} requests on a {PREFIX_SHORT_SYSTEM}-token system prompt, the even "
        f"ones sampled) in {short_s:.2f}s: prefix hits {stats2['hits']} of "
        f"{stats2['lookups']}, prefill tokens skipped {sched2['prefill_tokens_skipped']}, bad "
        f"generations {bad2}; launches {short_launches}; its decode horizons, wall ms/step: "
        f"greedy {short_ms['greedy']}, sampled {short_ms['sampled']} (in turns)")
    if bad2 or stats2["hits"] < PREFIX_REQUESTS - 1:
        failures.append(f"short-context wave: hits {stats2['hits']}, bad generations {bad2}")
    for key in ("paged_prefill", "paged_decode"):
        if short_launches[key] <= 0:
            failures.append(f"{key} never launched in the short-context wave")

    peak = torch.cuda.max_memory_allocated()
    log(f"[prefix_sample] peak memory {peak / 2**30:.2f} GiB; {smi}")
    short.shutdown()
    engine.shutdown()
    del short, engine
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError("prefix_sample: " + "; ".join(failures))
    record.update(hits=stats["hits"], lookups=stats["lookups"], prefill_tokens_skipped=skipped,
                  cow_copies=stats["cow_copies"], wave_s=wave_s, wave_ttft_ms=ttft_ms,
                  wave_launches=wave_launches, shared_blocks_crc=[seen["crc_before"], crc_after],
                  hit_ttft_ms=1e3 * hit[1][1], cold_ttft_ms=1e3 * cold[1][1],
                  hit_logits_rel_l2=rel_hit, cow_hit_logits_rel_l2=rel_cow,
                  promote_ms=1e3 * promote_s,
                  promoted_blocks=snap["promotions_host"], promoted_logits_rel_l2=rel_prom,
                  decode_ms_per_step=horizon_ms, sampler_ms=sampler_ms, chi2=chi2,
                  chi2_dof=dof, chi2_p=p_value, peak_gib=peak / 2**30, short_wave_s=short_s,
                  short_wave_hits=stats2["hits"], short_wave_launches=short_launches,
                  short_decode_ms_per_step=short_ms)
    return {"wave": wave_launches, "short_wave": short_launches}, record


# ---------------------------------------------------------------------------
# phase 20: the model families and the HuggingFace checkpoint loader
# ---------------------------------------------------------------------------

def _family_serve(engine, rng, tag):
    """The serving main path's waves on ``engine`` (counted), one prefill's
    logits against the plain route and a decode profile. Returns its
    record, the launches under "launches"."""
    import numpy as np

    launches, wave_b, record = _serve_waves(engine, rng, tag)
    record["logits_rel_l2"] = _plain_route_rel(engine, wave_b[1][0].astype(np.int32), tag)
    wall, device = profile_decode(engine, rng, tag=tag)
    record.update(decode_ms_step_wall=wall, decode_ms_step_device=device, launches=launches)
    return record


def _hf_qwen2_tensors(cfg, seed, device):
    """A Qwen2 checkpoint's tensors in HF naming, bf16, drawn on ``device``
    from a seeded generator: weights ``[out, in]`` at 1/sqrt(fan_in),
    embedding and biases at 0.02, norm scales 1 + 0.02 N(0, 1). Returns
    {name: tensor} and {name: (group, leaf, layer or None, transposed)}: where
    each lands in the port's tree, written here apart from the loader's own
    table."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    tensors, where = {}, {}

    def add(name, shape, scale, target, offset=0.0):
        t = torch.randn(shape, generator=gen, device=device).mul_(scale).add_(offset)
        tensors[name] = t.to(torch.bfloat16)
        where[name] = target

    add("model.embed_tokens.weight", (V, H), 0.02, ("embed", "embedding", None, False))
    for i in range(cfg.num_layers):
        b = f"model.layers.{i}."
        add(b + "input_layernorm.weight", (H, ), 0.02, ("blocks", "ln1_scale", i, False), 1.0)
        for n, leaf, out in (("q", "q", q), ("k", "k", kv), ("v", "v", kv)):
            add(b + f"self_attn.{n}_proj.weight", (out, H), H**-0.5,
                ("blocks", "w" + leaf, i, True))
            add(b + f"self_attn.{n}_proj.bias", (out, ), 0.02, ("blocks", "b" + leaf, i, False))
        add(b + "self_attn.o_proj.weight", (H, q), q**-0.5, ("blocks", "wo", i, True))
        add(b + "post_attention_layernorm.weight", (H, ), 0.02, ("blocks", "ln2_scale", i, False),
            1.0)
        add(b + "mlp.gate_proj.weight", (F, H), H**-0.5, ("blocks", "w_gate", i, True))
        add(b + "mlp.up_proj.weight", (F, H), H**-0.5, ("blocks", "w_up", i, True))
        add(b + "mlp.down_proj.weight", (H, F), F**-0.5, ("blocks", "w_down", i, True))
    add("model.norm.weight", (H, ), 0.02, ("final_norm", "scale", None, False), 1.0)
    add("lm_head.weight", (V, H), H**-0.5, ("lm_head", "kernel", None, True))
    return tensors, where


def _write_safetensors(path, tensors):
    """A ``.safetensors`` file of bf16 tensors: the 8-byte little-endian
    header length, the JSON header padded with spaces to 8 bytes, then each
    tensor's bytes in order."""
    import struct

    import torch

    header, off = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.cpu().contiguous().view(torch.int16).numpy())
    return 8 + len(raw) + off


@contextlib.contextmanager
def _rss_sampler(every_s=0.002):
    """This process's resident memory (``/proc/self/statm``, read only)
    before a block and the most a thread sampling it every ``every_s``
    seconds saw during it: {"before", "peak" (bytes), "samples"}."""
    import threading

    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    out = {"before": rss(), "peak": 0, "samples": 0}
    done = threading.Event()

    def sample():
        while not done.is_set():
            out["peak"] = max(out["peak"], rss())
            out["samples"] += 1
            done.wait(every_s)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        done.set()
        t.join()
        out["peak"] = max(out["peak"], rss())


def _hf_round_trip(smi):
    """Write a Qwen2-7B-width checkpoint of ``FAMILIES_HF_LAYERS`` layers
    in HF naming as bf16 ``.safetensors`` in ``FAMILIES_HF_SHARDS`` shards
    plus ``config.json`` into a temporary directory (removed afterwards),
    load it with ``build_hf_engine``, and check every loaded tensor against
    what was written (bit for bit, after its transpose) and a put's logits
    against the plain route. Returns the record."""
    import tempfile

    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig,
                                                  RaggedInferenceEngineConfig, build_hf_engine)
    from deepspeed_tpu_torch.models import qwen2_config

    dev = torch.device("cuda")
    cfg = qwen2_config(FAMILIES_QWEN[0], **dict(FAMILIES_QWEN[1], num_layers=FAMILIES_HF_LAYERS))
    tensors, where = _hf_qwen2_tensors(cfg, 20, dev)
    hf_cfg = {"architectures": ["Qwen2ForCausalLM"], "model_type": "qwen2",
              "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "intermediate_size": cfg.intermediate_size, "num_hidden_layers": cfg.num_layers,
              "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
              "max_position_embeddings": cfg.max_seq_len, "rope_theta": cfg.rope_theta,
              "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
              "torch_dtype": "bfloat16"}
    names = list(tensors)
    cut = -(-len(names) // FAMILIES_HF_SHARDS)
    with tempfile.TemporaryDirectory(prefix="hf_qwen2_") as d:
        t0 = time.perf_counter()
        n_bytes, index = 0, {}
        for k in range(FAMILIES_HF_SHARDS):
            fname = f"model-{k + 1:05d}-of-{FAMILIES_HF_SHARDS:05d}.safetensors"
            part = {n: tensors[n] for n in names[k * cut:(k + 1) * cut]}
            n_bytes += _write_safetensors(os.path.join(d, fname), part)
            index.update({n: fname for n in part})
        with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": n_bytes}, "weight_map": index}, f)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(hf_cfg, f)
        write_s = time.perf_counter() - t0
        with _rss_sampler() as rss:
            t0 = time.perf_counter()
            engine = build_hf_engine(d, RaggedInferenceEngineConfig(
                kv_block_size=64, state_manager=DSStateManagerConfig(max_context=2048)))
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
    bad = []
    for name, (group, leaf, layer, transposed) in where.items():
        got = engine.params[group][leaf]
        got = got if layer is None else got[layer]
        want = tensors[name].t() if transposed else tensors[name]
        if got.shape != want.shape or not torch.equal(got, want.to(got.dtype)):
            bad.append(name)
    log(f"[families] HF round trip: {len(where)} tensors ({n_bytes / 1e9:.3f} GB, "
        f"{FAMILIES_HF_SHARDS} bf16 .safetensors shards, Qwen2-{FAMILIES_QWEN[0]} width, "
        f"{cfg.num_layers} layers) written in {write_s:.2f} s; build_hf_engine {load_s:.2f} s "
        f"({n_bytes / 1e9 / load_s:.2f} GB/s; the files were just written: a warm read); host "
        f"resident memory {rss['before'] / 2**20:.0f} MiB before, at most "
        f"{rss['peak'] / 2**20:.0f} during the load ({rss['samples']} samples; the largest "
        f"tensor {max(t.numel() for t in tensors.values()) * 2 / 2**20:.0f} MiB); tensors equal "
        f"to what was written: "
        f"{len(where) - len(bad)} of {len(where)}; {smi}")
    del tensors
    if bad:
        raise RuntimeError(f"[families] loaded tensors differ from the checkpoint: {bad[:8]}")
    rng = np.random.default_rng(20)
    rel = _plain_route_rel(engine, rng.integers(0, cfg.vocab_size, 512).astype(np.int32),
                           "[families] hf")
    del engine
    return dict(tensors=len(where), bytes=n_bytes, shards=FAMILIES_HF_SHARDS, write_s=write_s,
                load_s=load_s, load_gb_s=n_bytes / 1e9 / load_s,
                host_rss_mib={"before": rss["before"] / 2**20, "peak": rss["peak"] / 2**20},
                logits_rel_l2=rel)


def phase_families():
    """The model families on the paged kernels: Qwen2-7B at full size (GQA
    28/4, g 7) through ``build_model_engine``; Bloom-7b1 at full width, depth
    cut to 4 (MHA, ALiBi, embedding LayerNorm, a tied 250,880 vocabulary)
    through ``build_engine(bloom(...))``; phi-2 (head_dim 80, depth 4)
    through ``build_model_engine``, Falcon-7B (71 query heads over 1 kv
    head, depth 4) and GPT-J-6B (head_dim 256, depth 2) through
    ``build_engine``; the HF checkpoint round trip; and a head_dim 32 model
    (phi's tiny preset) refused at engine build, naming the miss. Returns
    the launches of each served model and the phase's record."""
    import gc

    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference.v2 import (DSStateManagerConfig,
                                                  RaggedInferenceEngineConfig, build_engine,
                                                  build_model_engine)
    from deepspeed_tpu_torch.models import bloom, falcon, gptj

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = RaggedInferenceEngineConfig(kv_block_size=64,
                                      state_manager=DSStateManagerConfig(max_context=2048))
    record, launches = {"card": smi}, {}
    for key, build in (
            ("qwen2_7b", lambda: build_model_engine("qwen2", FAMILIES_QWEN[0], cfg, seed=0,
                                                    **FAMILIES_QWEN[1])),
            ("bloom_7b1", lambda: build_engine(bloom(FAMILIES_BLOOM[0], seed=0,
                                                     **FAMILIES_BLOOM[1]), cfg)),
            ("phi_2", lambda: build_model_engine("phi", FAMILIES_PHI[0], cfg, seed=0,
                                                 **FAMILIES_PHI[1])),
            ("falcon_7b", lambda: build_engine(falcon(FAMILIES_FALCON[0], seed=0,
                                                      **FAMILIES_FALCON[1]), cfg)),
            ("gptj_6b", lambda: build_engine(gptj(FAMILIES_GPTJ[0], seed=0, **FAMILIES_GPTJ[1]),
                                             cfg))):
        tag = f"[families] {key}"
        t0 = time.perf_counter()
        engine = build()
        torch.cuda.synchronize()
        mc = engine.model_config
        log(f"{tag}: {mc.num_layers} layers, hidden {mc.hidden_size}, heads {mc.num_heads}/"
            f"{mc.num_kv_heads} (g {mc.num_heads // mc.num_kv_heads}, d {mc.head_dim}), "
            f"positions {mc.positions}, vocab {mc.vocab_size}, "
            f"{engine.module.num_params() / 1e9:.3f}B params, KV pool {engine.num_kv_blocks} x 64, "
            f"built in {time.perf_counter() - t0:.1f}s")
        rec = _family_serve(engine, np.random.default_rng(0), tag)
        launches[key] = rec.pop("launches")
        record[key] = rec
        log(f"{tag}: TTFT p50 {rec['ttft_p50_ms']:.1f} ms, decode {rec['decode_ms_step_wall']:.2f} "
            f"ms/step wall, {rec['decode_ms_step_device']:.2f} device, peak {rec['peak_gib']:.2f} "
            f"GiB, logits rel L2 {rec['logits_rel_l2']:.3e}, launches {launches[key]}; {smi}")
        del engine
        free()
    record["hf_round_trip"] = _hf_round_trip(smi)
    free()
    # a shape still outside the kernels' rule: head_dim 32 (the CPU-only
    # tiny presets) is refused when the engine is built, naming the miss
    try:
        build_model_engine("phi", "tiny", cfg, num_layers=1)
    except ValueError as e:
        if "head_dim 32" not in str(e) or "A5b" not in str(e):
            raise RuntimeError(f"[families] phi tiny refused for another reason: {e}") from e
        refused = {"phi_tiny": str(e).split(": ", 1)[-1]}
    else:
        raise RuntimeError("[families] phi tiny (head_dim 32) was not refused at engine build")
    free()
    log(f"[families] refused at engine build: {refused}")
    record["refused"] = refused
    return launches, record


# ---------------------------------------------------------------------------
# phase 22: training at the families' head dims (flash kernels at d 80 / 96 /
# 256)
# ---------------------------------------------------------------------------

def phase_families_train():
    """phi-2 (d 80), GPT-NeoX-20B (d 96) and GPT-J-6B (d 256) at full width,
    depth cut to 2, trained through ``initialize`` and ``train_batch`` on
    ``TRAIN_DS_CONFIG``'s recipe at seq 2048; then a head_dim 32 model (phi's
    tiny preset) refused at ``initialize``, naming the miss. Returns
    ({model: launches of the timed steps}, the phase's record)."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import models
    from deepspeed_tpu_torch.models import TransformerLM
    from deepspeed_tpu_torch.models.transformer import training_attention_route
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    free()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    record, launches = {"card": smi}, {}
    for key, (family, size, layers) in FAMILIES_TRAIN.items():
        tag = f"[families_train] {key}"
        t0 = time.perf_counter()
        cfg = getattr(models, f"{family}_config")(size, num_layers=layers)
        route = training_attention_route(cfg, "cuda")
        if route != "flash":
            raise RuntimeError(f"{tag}: the training route is {route!r}, not the flash kernels")
        model = TransformerLM(cfg, trainable=True, seed=0)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=TRAIN_DS_CONFIG)
        params = engine._params
        n_params = sum(p.numel() for p in params)
        gas = engine.gradient_accumulation_steps()
        torch.cuda.synchronize()
        full_depth = getattr(models, f"{family}_config")(size).num_layers
        log(f"{tag}: {layers} layers (the preset's {full_depth} cut), "
            f"hidden {cfg.hidden_size}, heads {cfg.num_heads}/{cfg.num_kv_heads}, head_dim "
            f"{cfg.head_dim}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f}B fp32 master params "
            f"({16 * n_params / 1e9:.1f} GB with grads and moments); built in "
            f"{time.perf_counter() - t0:.1f}s")
        rng = np.random.default_rng(0)
        batch = {"input_ids": rng.integers(0, cfg.vocab_size, (engine.train_batch_size(),
                                                               FAMILIES_TRAIN_SEQ)).astype(np.int32)}
        tokens = batch["input_ids"].size
        losses = [float(engine.train_batch(batch))]  # warm step
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        fad.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(FAMILIES_TRAIN_STEPS):
            ts = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - ts)
        got = {**fa.launch_counts, **fad.launch_counts}
        peak = torch.cuda.max_memory_allocated() / 2**30
        med = float(np.median(times))
        n_attn = layers * gas * FAMILIES_TRAIN_STEPS
        want = {"flash_fwd": n_attn, "flash_bwd_dkdv": n_attn, "flash_bwd_dq": n_attn,
                "fused_adam": FAMILIES_TRAIN_STEPS}
        log(f"{tag}: {gas} microbatches x {FAMILIES_TRAIN_SEQ} tokens = {tokens} tokens/step; "
            f"losses (warm step, then {FAMILIES_TRAIN_STEPS} timed): "
            f"{[round(x, 5) for x in losses]}; step time median {1e3 * med:.1f} ms (range "
            f"{1e3 * min(times):.1f}-{1e3 * max(times):.1f}): {tokens / med:.1f} tokens/s; peak "
            f"memory {peak:.2f} GiB; launches {got} (expected {want}); {smi}")
        if got != want:
            raise RuntimeError(f"{tag}: launches {got}, expected {want} ({layers} layers x {gas} "
                               f"microbatches x {FAMILIES_TRAIN_STEPS} steps; Adam once a step)")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise RuntimeError(f"{tag}: losses not finite and falling: {losses}")

        # kernels vs the plain attention on the same weights at seq 1024
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, CHECK_SEQ))).cuda()

        def loss_and_grads(impl):
            cfg.attention_impl = impl
            for p in params:
                p.grad = None
            loss = model.loss({"input_ids": ids})
            loss.backward()
            return loss.item(), [p.grad for p in params]

        l_k, g_k = loss_and_grads("flash")
        l_r, g_r = loss_and_grads("reference")
        cfg.attention_impl = "auto"
        g_rel = _rel_l2(g_k, g_r)
        l_rel = abs(l_k - l_r) / abs(l_r)
        log(f"{tag}: seq {CHECK_SEQ} forward+backward, kernels vs plain attention on the same "
            f"weights: loss {l_k:.6f} vs {l_r:.6f} (relative {l_rel:.3e}, tolerance "
            f"{LOSS_REL_TOL}); whole-gradient relative L2 {g_rel:.3e} (tolerance "
            f"{GRAD_REL_L2_TOL})")
        if not (np.isfinite(l_k) and l_rel <= LOSS_REL_TOL and g_rel <= GRAD_REL_L2_TOL):
            raise RuntimeError(f"{tag}: the kernel path disagrees with the plain attention")
        launches[key] = got
        record[key] = dict(layers=layers, head_dim=cfg.head_dim, params=n_params, losses=losses,
                           step_ms=1e3 * med, tokens_per_s=tokens / med, peak_gib=peak,
                           loss_rel=l_rel, grad_rel_l2=g_rel)
        del engine, model, params, g_k, g_r
        free()
        # the v1 engine's full-sequence forward at this width takes the same
        # flash forward, once a layer
        v1 = deepspeed_tpu_torch.init_inference(
            getattr(models, family)(size, num_layers=layers, seed=0), config={"dtype": "bfloat16"})
        fa.reset_launch_counts()
        logits = v1.forward(rng.integers(0, cfg.vocab_size, (1, CHECK_SEQ)).astype(np.int32))
        torch.cuda.synchronize()
        v1_fwd = fa.launch_counts["flash_fwd"]
        log(f"{tag}: init_inference(...).forward on 1 x {CHECK_SEQ} tokens: logits "
            f"{tuple(logits.shape)}, flash_fwd launches {v1_fwd} (expected {layers})")
        if (v1_fwd != layers or tuple(logits.shape) != (1, CHECK_SEQ, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())):
            raise RuntimeError(f"{tag}: the v1 forward did not take the flash forward once a "
                               f"layer with finite logits")
        record[key]["v1_forward_flash_fwd_launches"] = v1_fwd
        del v1, logits
        free()
    # a shape still outside the flash kernels' rule: head_dim 32 (the
    # CPU-only tiny presets) is refused at initialize, naming the miss
    model = TransformerLM(models.phi_config("tiny", num_layers=1), trainable=True, seed=0)
    try:
        deepspeed_tpu_torch.initialize(model=model, config=TRAIN_DS_CONFIG)
    except ValueError as e:
        if "head_dim 32" not in str(e) or "A5b" not in str(e):
            raise RuntimeError(f"[families_train] phi tiny refused for another reason: {e}") from e
        record["refused"] = {"phi_tiny": str(e)}
    else:
        raise RuntimeError("[families_train] phi tiny (head_dim 32) was not refused at initialize")
    del model
    free()
    log(f"[families_train] refused at initialize: {record['refused']}")
    return launches, record
# ---------------------------------------------------------------------------
# phase: ZeRO-Offload (the host optimizer, its NVMe tier, twin-flow)
# ---------------------------------------------------------------------------

# Mistral-7B's widths; (b) parity at OFFLOAD_PARITY_LAYERS, (c) NVMe at
# OFFLOAD_NVME_LAYERS, (d) the deepest run at OFFLOAD_FULL_LAYERS. 32 layers
# fit the card (55.51 GiB) and the host (88.66 GiB resident of 101 GiB) but
# not the phase's 90 s: pinning and first touch of host memory run at ~1.4
# and ~3 GB/s on the card's machine, so (d) costs ~1.8 s a layer (62 s at
# 32 layers alone, 39 s at 20 in the whole script) beside (a)-(c)'s ~63 s
# (PERF.md, PR 23); its depth is cut to what the phase's 90 s allows
OFFLOAD_SEQ = 2048
OFFLOAD_PARITY_LAYERS, OFFLOAD_PARITY_STEPS = 8, 3
OFFLOAD_NVME_LAYERS, OFFLOAD_NVME_STEPS = 2, 2
OFFLOAD_FULL_LAYERS, OFFLOAD_FULL_STEPS = 10, 2
OFFLOAD_ADAM_ELEMENTS = 2_007_000_000  # the parity model's parameter count, rounded
OFFLOAD_AIO_BYTES = 1 << 30
# the train phase's recipe without its warm-up schedule (so every step
# moves the weights): bf16, AdamW lr 1e-4, clipping, gas 2 of 1 x 2048
OFFLOAD_DS_CONFIG = dict({k: v for k, v in TRAIN_DS_CONFIG.items() if k != "scheduler"})
# parameters after the parity steps: ||p_run - p_device|| within this
# fraction of ||p_device - p_0|| (what the steps moved them); the C++ and
# the card's Adam differ in fp32 rounding only (~1e-7 of an update a step)
OFFLOAD_PARAM_REL_TOL = 1e-2
OFFLOAD_PEAK_DROP_MIN = 0.9  # full offload frees at least this share of 8 B a parameter


def _meminfo():
    """(MemTotal, MemAvailable) in bytes, read from /proc/meminfo."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            out[key] = int(val.split()[0]) * 1024
    return out["MemTotal"], out["MemAvailable"]


def _offload_host_machine(rec):
    """(a): the host's memory, CPUs and disk; the C++ Adam over
    OFFLOAD_ADAM_ELEMENTS fp32 elements; 1 GiB through the aio handle."""
    import shutil
    import tempfile

    import torch

    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam
    from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
    from deepspeed_tpu_torch.runtime.zero.offload import _host_buffer

    total, avail = _meminfo()
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    disk = shutil.disk_usage(build)
    log(f"[offload] host: MemTotal {total / 2**30:.1f} GiB, MemAvailable {avail / 2**30:.1f} GiB, "
        f"{os.cpu_count()} CPUs, {disk.free / 2**30:.1f} GiB free under build/")
    thp_file = "/sys/kernel/mm/transparent_hugepage/enabled"
    thp = open(thp_file).read().strip() if os.path.exists(thp_file) else "absent"  # read only
    log(f"[offload] transparent huge pages: {thp}")
    n = OFFLOAD_ADAM_ELEMENTS
    bufs = [_host_buffer(n) for _ in range(4)]  # zero pages: the first call faults them in
    opt = DeepSpeedCPUAdam(lr=1e-4, weight_decay=0.1)
    times = []
    for step in (1, 2):
        t0 = time.perf_counter()
        opt.step(step, *bufs, grad_scale=1.0)
        times.append(time.perf_counter() - t0)
    ms = 1e3 * times[1]
    gbs = 28 * n / (ms * 1e-3) / 1e9  # read p, g, m, v; write p, m, v
    log(f"[offload] DeepSpeedCPUAdam over {n:,} fp32 elements: {ms:.1f} ms a step "
        f"({gbs:.1f} GB/s of 28 B an element; the first call, which faults the "
        f"{16 * n / 1e9:.0f} GB in, {1e3 * times[0]:.1f} ms)")
    del bufs
    tmp = tempfile.mkdtemp(dir=build, prefix="offload_aio_")
    try:
        src = torch.arange(OFFLOAD_AIO_BYTES // 4, dtype=torch.int32)
        dst = torch.empty_like(src)
        h = AsyncIOHandle(thread_count=4)
        path = os.path.join(tmp, "aio.bin")
        t0 = time.perf_counter()
        h.async_pwrite(src, path)
        h.wait()
        w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h.async_pread(dst, path)
        h.wait()
        r_s = time.perf_counter() - t0
        h.close()
        if not torch.equal(src, dst):
            raise RuntimeError("[offload] the aio round trip did not read back what it wrote")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[offload] AsyncIOHandle 1 GiB under build/: write {1e3 * w_s:.1f} ms "
        f"({OFFLOAD_AIO_BYTES / w_s / 1e9:.2f} GB/s, into the page cache), read "
        f"{1e3 * r_s:.1f} ms ({OFFLOAD_AIO_BYTES / r_s / 1e9:.2f} GB/s, warm); read back equal")
    rec["host"] = dict(mem_total=total, mem_available=avail, cpus=os.cpu_count(),
                       build_free=disk.free, thp=thp, cpu_adam_ms=ms, cpu_adam_gbs=gbs,
                       cpu_adam_elements=n, aio_write_ms=1e3 * w_s, aio_read_ms=1e3 * r_s)


def _offload_run(layers, steps, zero, remat=False, keep=False, update_norm=False):
    """Mistral-7B's widths at ``layers``, seed 0, ``steps`` train_batch
    steps on one seeded batch under ``zero`` (the zero_optimization
    block). Returns {losses, step_ms, split_ms (median ms of each part of
    the offloaded steps), launches, peak_gib (above what was allocated
    before), params (copies on the card when ``keep``), update_norm
    (||p - p_0|| when ``update_norm``), setup_s}."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg = mistral_config("7b", num_layers=layers, remat=remat)
    model = TransformerLM(cfg, trainable=True, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(OFFLOAD_DS_CONFIG, zero_optimization=zero))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (engine.train_batch_size(),
                                                           OFFLOAD_SEQ)).astype(np.int32)}
    fa.reset_launch_counts()
    losses, times, splits = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        splits.append(dict(engine.offload_times))
    launches = dict(fa.launch_counts)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    host = engine.host_optimizer
    out = dict(layers=layers, losses=losses, step_ms=times, launches=launches, peak_gib=peak,
               n_params=sum(p.numel() for p in engine._params), setup_s=setup_s,
               host_bytes=host.host_bytes() if host else None,
               host_init_ms=host.init_times if host else None,
               twin_host_tensors=(sum(engine._twin_host) if engine._twin_host else None))
    if splits and splits[0]:
        out["split_ms"] = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    if keep:
        out["params"] = [p.detach().clone() for p in engine._params]
    if host is not None:
        host.close()
    del engine, model, host
    gc.collect()
    torch.cuda.empty_cache()
    if update_norm:  # the initial weights again, from the seed
        p0 = TransformerLM(cfg, trainable=True, seed=0)
        out["update_norm"] = _norm_of_diff(out["params"], list(p0.parameters()))
        del p0
        torch.cuda.empty_cache()
    return out


def _norm_of_diff(xs, ys):
    """||xs - ys|| over lists of tensors, summed in float64 on the card."""
    import torch

    with torch.no_grad():
        return float(sum(torch.linalg.vector_norm((a.double() - b.double())).square()
                         for a, b in zip(xs, ys)))**0.5


def _offload_log(tag, run, smi):
    split = run.get("split_ms")
    parts = ("" if not split else
             f"; split (median ms): forward/backward + norm {split['to_norm_ms']:.1f}, gradient "
             f"D2H wait {split['d2h_wait_ms']:.1f}, host Adam {split['host_adam_ms']:.1f}, "
             f"upload tail {split['upload_ms']:.1f}, NVMe swap {split['swap_ms']:.1f}")
    log(f"[offload] {tag}: {run['layers']} layers, {run['n_params'] / 1e9:.3f}B params, set up "
        f"in {run['setup_s']:.1f} s (host ms: "
        f"{ {k: round(v, 1) for k, v in (run['host_init_ms'] or {}).items()} }); losses "
        f"{[round(x, 5) for x in run['losses']]}; step ms {[round(t, 1) for t in run['step_ms']]}"
        f"{parts}; device peak {run['peak_gib']:.2f} GiB; flash launches {run['launches']}; "
        f"{smi}")


def phase_offload():
    """ZeRO-Offload through ``initialize`` / ``train_batch`` at Mistral-7B's
    widths. Returns ({run: flash launches}, the phase's record)."""
    import math
    import shutil
    import tempfile

    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    rec, launches = {"card": smi}, {}
    t_phase = time.perf_counter()

    def mark(what):
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        log(f"[offload] {what} at {time.perf_counter() - t_phase:.1f} s; resident "
            f"{rss / 2**30:.2f} GiB")

    _offload_host_machine(rec)
    mark("(a) done")

    # (b) parity at OFFLOAD_PARITY_LAYERS: device AdamW, cpu offload, twin-flow 0.5
    runs = {
        "device": _offload_run(OFFLOAD_PARITY_LAYERS, OFFLOAD_PARITY_STEPS, {"stage": 0},
                               keep=True, update_norm=True),
        "cpu": _offload_run(OFFLOAD_PARITY_LAYERS, OFFLOAD_PARITY_STEPS,
                            {"stage": 0, "offload_optimizer": {"device": "cpu"}}, keep=True),
        "twin_0.5": _offload_run(OFFLOAD_PARITY_LAYERS, OFFLOAD_PARITY_STEPS,
                                 {"stage": 0, "offload_optimizer": {"device": "cpu",
                                                                    "ratio": 0.5}}, keep=True),
    }
    dev = runs["device"]
    worst, failures = 0.0, []
    n_params = dev["n_params"]
    expected_drop = 8 * n_params / 2**30
    for name, run in runs.items():
        _offload_log(f"parity {name}", run, smi)
        launches[name] = run["launches"]
        if name == "device":
            continue
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], dev["losses"]))
        p_rel = _norm_of_diff(run["params"], dev["params"]) / dev["update_norm"]
        frac = max(loss_rel / LOSS_REL_TOL, p_rel / OFFLOAD_PARAM_REL_TOL)
        worst = max(worst, frac)
        drop = dev["peak_gib"] - run["peak_gib"]
        log(f"[offload] parity {name} vs device AdamW: losses within {loss_rel:.3e} (tolerance "
            f"{LOSS_REL_TOL}); parameters after {OFFLOAD_PARITY_STEPS} steps "
            f"||p - p_device|| / ||p_device - p_0|| = {p_rel:.3e} (tolerance "
            f"{OFFLOAD_PARAM_REL_TOL}); device peak {drop:+.2f} GiB below the device run's "
            f"(8 B x {n_params:,} of moments = {expected_drop:.2f} GiB)")
        if run["launches"] != dev["launches"]:
            failures.append(f"{name}: flash launches {run['launches']} != {dev['launches']}")
        if frac > 1.0:
            failures.append(f"{name}: {frac:.1f}x its tolerance")
        if name == "cpu" and drop < OFFLOAD_PEAK_DROP_MIN * expected_drop:
            failures.append(f"cpu: the device peak dropped {drop:.2f} GiB, not ~{expected_drop:.2f}")
        rec[f"parity_{name}"] = dict(loss_rel=loss_rel, param_rel=p_rel, peak_drop_gib=drop)
    log(f"[offload] parity worst_error_fraction={worst:.4g}")
    for name, run in runs.items():
        rec[name] = {k: v for k, v in run.items() if k not in ("params",)}
    if not all(r["launches"]["flash_fwd"] > 0 for r in runs.values()):
        failures.append("the flash kernels did not launch in every run")
    del runs, dev
    if failures:
        raise RuntimeError(f"offload disagrees: {failures}")

    mark("(b) done")

    # (c) NVMe at OFFLOAD_NVME_LAYERS: the parameters equal cpu offload's bit for bit
    nvme_dir = tempfile.mkdtemp(dir=os.path.join(HERE, "build"), prefix="offload_nvme_")
    try:
        cpu = _offload_run(OFFLOAD_NVME_LAYERS, OFFLOAD_NVME_STEPS,
                           {"stage": 0, "offload_optimizer": {"device": "cpu"}}, keep=True)
        nvme = _offload_run(OFFLOAD_NVME_LAYERS, OFFLOAD_NVME_STEPS,
                            {"stage": 0, "offload_optimizer": {
                                "device": "nvme", "nvme_path": nvme_dir, "pipeline_read": True,
                                "pipeline_write": True}}, keep=True)
    finally:
        shutil.rmtree(nvme_dir, ignore_errors=True)
    _offload_log("nvme", nvme, smi)
    unequal = sum(not torch.equal(a, b) for a, b in zip(cpu["params"], nvme["params"]))
    log(f"[offload] nvme vs cpu offload at {OFFLOAD_NVME_LAYERS} layers after "
        f"{OFFLOAD_NVME_STEPS} steps: {unequal} of {len(cpu['params'])} parameters differ "
        f"(must be 0: the same C++ kernel on the same data); losses {nvme['losses']} vs "
        f"{cpu['losses']}")
    if unequal or nvme["losses"] != cpu["losses"]:
        raise RuntimeError(f"offload disagrees: nvme differs from cpu offload in {unequal} "
                           f"parameters")
    launches["nvme"] = nvme["launches"]
    rec["nvme"] = {k: v for k, v in nvme.items() if k != "params"}
    del cpu, nvme

    mark("(c) done")

    # (d) the deepest run: cpu offload at OFFLOAD_FULL_LAYERS layers
    per_layer, rest = 218_112_000, 262_148_096  # Mistral-7B: a block's, and the rest's
    need = 12 * (OFFLOAD_FULL_LAYERS * per_layer + rest)  # masters + both moments
    total, avail = _meminfo()
    log(f"[offload] full run: {OFFLOAD_FULL_LAYERS} layers need {need / 2**30:.1f} GiB of host "
        f"masters and moments; MemAvailable {avail / 2**30:.1f} GiB")
    if need > avail:
        raise RuntimeError(f"[offload] the host lacks room for {OFFLOAD_FULL_LAYERS} layers")
    with _rss_sampler(every_s=0.01) as rss:  # remat where the activations need it (32 layers)
        full = _offload_run(OFFLOAD_FULL_LAYERS, OFFLOAD_FULL_STEPS,
                            {"stage": 0, "offload_optimizer": {"device": "cpu"}},
                            remat=OFFLOAD_FULL_LAYERS > 16)
    _offload_log("full depth", full, smi)
    log(f"[offload] full depth host resident peak {rss['peak'] / 2**30:.2f} GiB (before "
        f"{rss['before'] / 2**30:.2f}; host optimizer {full['host_bytes']}); device Adam would "
        f"need {16 * full['n_params'] / 1e9:.1f} GB of fp32 params, grads and moments")
    if not (all(map(math.isfinite, full["losses"])) and full["losses"][-1] < full["losses"][0]):
        raise RuntimeError(f"[offload] full depth losses not finite and falling: "
                           f"{full['losses']}")
    launches["full"] = full["launches"]
    rec["full"] = dict(full, host_rss_peak=rss["peak"], host_rss_before=rss["before"])
    mark("(d) done")
    return launches, rec


# ---------------------------------------------------------------------------
# phase: the 1-bit optimizers and pipeline parallelism over two or four ranks
# ---------------------------------------------------------------------------

# 1-bit: Mistral-7B's widths at ZERO_VOCAB, freeze_step 1 and 3 steps (one
# exact, two compressed), data = the world; the exact step held to the
# stage-0 data-parallel step (dp:adam, the same world) within
# ZERO_WORLD1_REL_TOL. The compressed exchange of the leaves ONEBIT_CHECKED is
# recomputed in one process from the ranks' local gradients, the check
# carrying its own error buffers from zero at the first compressed step, and
# held to the ranks' exchanged gradient and both new error buffers within
# ONEBIT_CHECK_REL_TOL (relative L2; the same fp32 operations). Pipeline:
# Mistral-7B's widths at the full 32,000 vocabulary (the embedding on the
# first stage, the head on the last), gas 4, 3 steps, 1F1B and GPipe, held
# to world size 1 on the same global batch within ZERO_WORLD1_REL_TOL
# (losses and gradient norms) and to each other within ZERO_REL_TOL. Case
# strings: onebit:<adam|lamb|zoadam>:<layers>, dp:adam:<layers>,
# pipe:<1f1b|gpipe>:<pipe>:<data>:<layers>.
PIPE_ONEBIT_GLOO_CASES = ("dp:adam:2", "onebit:adam:2", "onebit:lamb:2", "onebit:zoadam:2",
                          "pipe:1f1b:2:1:4", "pipe:gpipe:2:1:4")
PIPE_ONEBIT_NCCL_CASES = ("dp:adam:8", "onebit:adam:8", "pipe:1f1b:4:1:8", "pipe:1f1b:2:2:8",
                          "pipe:gpipe:2:2:8")
PIPE_ONEBIT_STEPS, PIPE_GAS, ONEBIT_FREEZE = 3, 4, 1
ONEBIT_CHECKED = (("blocks", "ln1_scale"), ("embed", "embedding"), ("final_norm", "scale"))
ONEBIT_CHECK_REL_TOL = 1e-5
ONEBIT_OPTIMIZERS = {"adam": ("OneBitAdam", 0), "lamb": ("OneBitLamb", 1),
                     "zoadam": ("ZeroOneAdam", 1)}
PIPE_VOCAB = 32000


def _pipe_onebit_config(case, world):
    """(ds_config, layers, vocab, data size, gas) of a pipe_onebit case."""
    kind, name, *rest = case.split(":")
    base = dict({k: v for k, v in TRAIN_DS_CONFIG.items() if k != "scheduler"},
                train_batch_size=None, train_micro_batch_size_per_gpu=1)
    if kind == "pipe":
        pipe, data, layers = map(int, rest)
        return (dict(base, gradient_accumulation_steps=PIPE_GAS,
                     optimizer={"type": "AdamW", "params": {"lr": 1e-3, "weight_decay": 0.1}},
                     zero_optimization={"stage": int(data > 1)}, pipeline={"schedule": name},
                     tpu={"pallas_fused_adam": "always", "mesh": {"pipe": pipe, "data": data}}),
                layers, PIPE_VOCAB, data, PIPE_GAS)
    layers = int(rest[0])
    opt, stage = ONEBIT_OPTIMIZERS[name] if kind == "onebit" else ("AdamW", 0)
    params = {"lr": 1e-3, "weight_decay": 0.1}
    if kind == "onebit":
        params["var_freeze_step" if name == "zoadam" else "freeze_step"] = ONEBIT_FREEZE
    return (dict(base, optimizer={"type": opt, "params": params},
                 zero_optimization={"stage": stage},
                 tpu={"pallas_fused_adam": "never", "mesh": {"data": world}}),
            layers, ZERO_VOCAB, world, base["gradient_accumulation_steps"])


def _pipe_onebit_ids(data_rank, gas, vocab):
    """Data rank ``data_rank``'s ids of every step: ``gas`` microbatches of
    1 x ZERO_SEQ."""
    import numpy as np

    rng = np.random.default_rng(2000 + data_rank)
    return rng.integers(0, vocab, (gas, ZERO_SEQ)).astype(np.int32)


def _onebit_recorder(engine, keep):
    """Record the engine's compressed exchange of the JAX leaves ``keep``
    (the engine exchanges every leaf once a compressed step, in the order of
    its sorted (group, name) keys): per compressed step {leaf: (local
    gradient, mean, new err_w, new err_s)} on the host. Returns (the
    records, a function undoing the patch)."""
    from deepspeed_tpu_torch.runtime.comm import compressed

    keys = sorted({(g, n) for g, n, p, _ in engine.module._leaves() if p.requires_grad})
    wanted = {keys.index(k): "/".join(k) for k in keep}
    real, steps, calls = compressed.onebit_allreduce, [], [0]

    def recording(x, ew, es, group=None, world=None):
        out = real(x, ew, es, group, world)
        step, unit = divmod(calls[0], len(keys))
        calls[0] += 1
        if unit == 0:
            steps.append({})
        if unit in wanted:
            steps[step][wanted[unit]] = tuple(t.detach().float().reshape(-1).cpu().clone()
                                              for t in (x, *out))
        return out

    compressed.onebit_allreduce = recording
    return steps, lambda: setattr(compressed, "onebit_allreduce", real)


def _pipe_onebit_rank_run(cases, out_path):
    """One rank of the pipe_onebit phase: each case through ``initialize``
    -> ``train_batch`` on this rank's rows (Mistral-7B widths from seed 0),
    the launch counts and the peak reset just before the steps and read
    just after. Writes {case: losses, gradient norms, step ms, peak GiB,
    launches, ...} as JSON to ``out_path`` and the 1-bit cases' recorded
    exchanges beside it (``<out_path>.onebit.pt``)."""
    import datetime
    import gc

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fad
    from deepspeed_tpu_torch.parallel import groups
    from deepspeed_tpu_torch.parallel.mesh import MeshConfig
    from deepspeed_tpu_torch.runtime.comm.compressed import onebit_wire_bytes

    deepspeed_tpu_torch.init_distributed(dist_backend=os.environ["ZERO_BACKEND"], verbose=False,
                                         timeout=datetime.timedelta(minutes=3))
    rank, world = comm.get_rank(), comm.get_world_size()
    out = {"rank": rank, "world": world, "backend": comm.get_backend(), "cases": {}}
    records = {}
    for case in cases:
        config, layers, vocab, data, gas = _pipe_onebit_config(case, world)
        cfg = mistral_config("7b", num_layers=layers, vocab_size=vocab)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if case.startswith("pipe:"):  # this rank's stage alone, drawn from the seed
            groups.initialize_mesh(MeshConfig(**config["tpu"]["mesh"]), "cuda")
            model = TransformerLM(cfg, trainable=True, seed=0, pipe_stage=(
                groups.get_pipe_parallel_rank(), groups.get_pipe_parallel_world_size()))
        else:
            model = TransformerLM(cfg, trainable=True, seed=0)
        engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=config)
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated() / 2**30
        batch = {"input_ids": _pipe_onebit_ids(engine.dp_rank, gas, vocab)}
        recorder = (_onebit_recorder(engine, ONEBIT_CHECKED) if case.startswith("onebit:")
                    else None)
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        fad.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, times, flags = [], [], [], []
        for _ in range(PIPE_ONEBIT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
            norms.append(float(engine.get_global_grad_norm()))
            flags.append(bool(getattr(engine, "onebit_compressed", False)))
        r = {"losses": losses, "grad_norms": norms, "step_ms": times,
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "init_peak_gib": init_peak,
             "launches": {**fa.launch_counts, **fad.launch_counts}, "layers": layers,
             "params": sum(p.numel() for p in engine._params), "gas": gas}
        if engine._pipe is not None:
            r.update(stage=engine._pipe.stage_id, data_rank=engine.dp_rank,
                     max_live=engine._pipe.max_live)
        if recorder is not None:
            recorder[1]()
            records[case] = recorder[0]
            sizes = [sum(engine._params[i].numel() for i in u) for u in engine._onebit_units]
            # computed from the sizes, not measured: the bytes one rank sends a step, a
            # ring all-reduce's 2 (w - 1) / w x 4n for the exact mean
            r.update(compressed=flags,
                     exact_sent_bytes=sum(8 * (world - 1) * n // world for n in sizes),
                     compressed_sent_bytes=sum(onebit_wire_bytes(n, world) for n in sizes))
        out["cases"][case] = r
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    comm.barrier()
    comm.destroy_process_group()
    torch.save(records, out_path + ".onebit.pt")
    with open(out_path, "w") as f:
        json.dump(out, f)


def _onebit_reference(xs, ews, ess):
    """The error-feedback 1-bit mean of the ranks' local gradients ``xs``
    with their error buffers, in one process, from the formulas (no sign
    packing): (the mean, [each rank's new err_w], [each rank's new
    err_s])."""
    import torch

    world, n = len(xs), xs[0].numel()
    chunk = -(-(-(-n // world)) // 8) * 8

    def sign(t):
        return torch.where(t >= 0, 1.0, -1.0)

    rows, scales, new_ew = [], [], []
    for x, ew in zip(xs, ews):
        c = torch.nn.functional.pad(x + ew, (0, chunk * world - n)).view(world, chunk)
        s = c.abs().mean(dim=1)
        rows.append(sign(c))
        scales.append(s)
        new_ew.append((c - s[:, None] * sign(c)).reshape(-1)[:n])
    outs, new_es = [], []
    for j in range(world):
        avg = torch.stack([scales[r][j] * rows[r][j] for r in range(world)]).mean(dim=0)
        cs = avg + ess[j]
        ss = cs.abs().mean()
        new_es.append(cs - ss * sign(cs))
        outs.append(ss * sign(cs))
    return torch.cat(outs)[:n], new_ew, new_es


def _onebit_check(paths, case):
    """The largest relative L2 difference of the ranks' recorded exchange
    (mean, new err_w, new err_s) to the one-process recomputation, the
    check's error buffers carried from zero over the compressed steps."""
    import torch

    recs = [torch.load(p + ".onebit.pt")[case] for p in paths]
    world = len(recs)
    worst, err = 0.0, {}
    for step in range(len(recs[0])):
        for leaf in recs[0][step]:
            xs = [rec[step][leaf][0] for rec in recs]
            n = xs[0].numel()
            chunk = -(-(-(-n // world)) // 8) * 8
            ews, ess = err.get(leaf, ([torch.zeros(n)] * world, [torch.zeros(chunk)] * world))
            want, want_ew, want_es = _onebit_reference(xs, ews, ess)
            err[leaf] = (want_ew, want_es)
            for r, rec in enumerate(recs):
                _, got, got_ew, got_es = rec[step][leaf]
                for g, w in ((got, want), (got_ew, want_ew[r]), (got_es, want_es[r])):
                    worst = max(worst, float((g - w).norm() / w.norm().clamp_min(1e-30)))
    return worst, len(recs[0])


def _pipe_world1(config, layers, data, gas):
    """A pipe case's configuration at world size 1 in this process on the
    global batch (micro ``data``: data rank d's row of each microbatch at
    d): (losses, gradient norms, step ms)."""
    import gc

    import numpy as np
    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_config

    model = TransformerLM(mistral_config("7b", num_layers=layers, vocab_size=PIPE_VOCAB),
                          trainable=True, seed=0)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=dict(
        config, train_micro_batch_size_per_gpu=data, zero_optimization={"stage": 0},
        pipeline={}, tpu={"pallas_fused_adam": "always"}))
    ids = np.stack([_pipe_onebit_ids(d, gas, PIPE_VOCAB) for d in range(data)], axis=1)
    res = _zero_train(engine, {"input_ids": ids.reshape(gas * data, ZERO_SEQ)},
                      PIPE_ONEBIT_STEPS)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_pipe_onebit():
    """The 1-bit optimizers and the pipeline over two gloo ranks sharing the
    card (or four NCCL ranks over four cards). Returns {case: {kernel: [per
    rank launches]}} and the phase's record."""
    import gc

    import numpy as np
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    n_dev = torch.cuda.device_count()
    world, backend = (4, "nccl") if n_dev >= 4 else (2, "gloo")
    cases = PIPE_ONEBIT_NCCL_CASES if backend == "nccl" else PIPE_ONEBIT_GLOO_CASES
    log(f"[pipe_onebit] {world} ranks over {backend} on {n_dev} visible device(s); Mistral-7B "
        f"widths, 1 x {ZERO_SEQ} tokens a rank a microbatch, bf16, clipping 1.0, lr 1e-3; "
        f"1-bit at vocab {ZERO_VOCAB}, gas 2, freeze_step {ONEBIT_FREEZE}; pipeline at vocab "
        f"{PIPE_VOCAB}, gas {PIPE_GAS}, fused AdamW; {PIPE_ONEBIT_STEPS} steps each; cases "
        f"{cases}")
    t0 = time.perf_counter()
    world1 = {}
    for case in cases:
        if case.startswith("pipe:"):
            config, layers, _, data, gas = _pipe_onebit_config(case, world)
            key = (layers, data)
            if key not in world1:
                world1[key] = _pipe_world1(config, layers, data, gas)
                log(f"[pipe_onebit] world size 1 at {layers} layers, micro {data}: losses "
                    f"{[round(x, 5) for x in world1[key][0]]}; gradient norms "
                    f"{[round(x, 5) for x in world1[key][1]]}; step ms "
                    f"{[round(t, 1) for t in world1[key][2]]}")
    log(f"[pipe_onebit] world size 1 references in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    ranks = _zero_spawn(world, backend, 0, cases, "pipe_onebit")
    paths = [os.path.join(HERE, "build", "zero", f"pipe_onebit_rank{r}.json")
             for r in range(world)]
    log(f"[pipe_onebit] ranks done in {time.perf_counter() - t0:.1f}s")
    launches, record, failures = {}, {"world": world, "backend": backend, "cases": {}}, []
    fractions = {}
    dp = next(c for c in cases if c.startswith("dp:"))
    for case in cases:
        got = [r["cases"][case] for r in ranks]
        launches[case] = {}
        for r, g in enumerate(got):
            for name, n in g["launches"].items():
                launches[case].setdefault(name, [0] * world)[r] += n
        rec = {"losses": got[0]["losses"], "grad_norms": got[0]["grad_norms"],
               "peak_gib": [g["peak_gib"] for g in got],
               "init_peak_gib": [g["init_peak_gib"] for g in got], "launches": launches[case],
               "step_ms": [g["step_ms"] for g in got], "params": [g["params"] for g in got]}
        config, layers, vocab, data, gas = _pipe_onebit_config(case, world)
        per_rank_layers = layers // (world // data) if case.startswith("pipe:") else layers
        n_attn = per_rank_layers * gas * PIPE_ONEBIT_STEPS
        want = {"flash_fwd": n_attn, "flash_bwd_dkdv": n_attn, "flash_bwd_dq": n_attn,
                "fused_adam": PIPE_ONEBIT_STEPS if case.startswith("pipe:") else 0}
        for r, g in enumerate(got):
            if g["launches"] != want:
                failures.append(f"{case} rank {r}: launches {g['launches']}, expected {want}")
            if not all(np.isfinite(g["losses"])) or g["losses"] != got[0]["losses"]:
                failures.append(f"{case} rank {r}: losses {g['losses']} not finite or not "
                                f"rank 0's {got[0]['losses']}")
        if case.startswith("onebit:"):
            base = ranks[0]["cases"][dp]
            exact = max(_rel(got[0]["losses"][:1], base["losses"][:1]),
                        _rel(got[0]["grad_norms"][:1], base["grad_norms"][:1]))
            if "lamb" not in case:  # the same AdamW update after the exact step
                exact = max(exact, _rel(got[0]["losses"][1:2], base["losses"][1:2]))
            check, n_steps = _onebit_check(paths, case)
            flags = got[0]["compressed"]
            if flags != [False] * ONEBIT_FREEZE + [True] * (PIPE_ONEBIT_STEPS - ONEBIT_FREEZE):
                failures.append(f"{case}: compressed steps {flags}")
            fractions[case] = max(exact / ZERO_WORLD1_REL_TOL, check / ONEBIT_CHECK_REL_TOL)
            rec.update(exact_rel_diff=exact, recompute_rel_l2=check, compressed=flags,
                       exact_sent_bytes=got[0]["exact_sent_bytes"],
                       compressed_sent_bytes=got[0]["compressed_sent_bytes"])
            log(f"[pipe_onebit] {case}: losses {[round(x, 5) for x in got[0]['losses']]}, "
                f"gradient norms {[round(x, 5) for x in got[0]['grad_norms']]}; steps "
                f"compressed {flags}; the exact step against {dp}: largest relative difference "
                f"{exact:.3e} (tolerance {ZERO_WORLD1_REL_TOL}); the exchange of "
                f"{len(ONEBIT_CHECKED)} leaves over {n_steps} compressed steps against the "
                f"one-process recomputation: largest relative L2 {check:.3e} (tolerance "
                f"{ONEBIT_CHECK_REL_TOL}); bytes a rank sends a step, computed from the sizes: "
                f"exact {got[0]['exact_sent_bytes']:,} (a ring all-reduce), compressed "
                f"{got[0]['compressed_sent_bytes']:,}; step ms by rank "
                f"{[[round(t, 1) for t in g['step_ms']] for g in got]} (step 1 exact); peak GiB "
                f"{[round(g['peak_gib'], 2) for g in got]}; launches {launches[case]}")
            if exact > ZERO_WORLD1_REL_TOL or check > ONEBIT_CHECK_REL_TOL:
                failures.append(f"{case}: exact step {exact:.3e}, exchange {check:.3e}")
        elif case.startswith("pipe:"):
            w1 = world1[(layers, data)]
            rel = max(_rel(got[0]["losses"], w1[0]), _rel(got[0]["grad_norms"], w1[1]))
            fractions[case] = rel / ZERO_WORLD1_REL_TOL
            rec.update(world1_rel_diff=rel, stages=[g["stage"] for g in got],
                       max_live=[g["max_live"] for g in got])
            log(f"[pipe_onebit] {case}: losses {[round(x, 5) for x in got[0]['losses']]}, "
                f"gradient norms {[round(x, 5) for x in got[0]['grad_norms']]}; against world "
                f"size 1: largest relative difference {rel:.3e} (tolerance "
                f"{ZERO_WORLD1_REL_TOL}); stage by rank {rec['stages']}, most live "
                f"microbatches {rec['max_live']}; step ms by rank "
                f"{[[round(t, 1) for t in g['step_ms']] for g in got]}; peak GiB by rank "
                f"{[round(g['peak_gib'], 2) for g in got]} in the steps, "
                f"{[round(g['init_peak_gib'], 2) for g in got]} building the stage and "
                f"initialize; parameters by rank "
                f"{rec['params']}; launches {launches[case]}")
            if rel > ZERO_WORLD1_REL_TOL:
                failures.append(f"{case} against world size 1: relative {rel:.3e}")
        else:
            log(f"[pipe_onebit] {case}: losses {[round(x, 5) for x in got[0]['losses']]}, "
                f"gradient norms {[round(x, 5) for x in got[0]['grad_norms']]}; step ms "
                f"{[[round(t, 1) for t in g['step_ms']] for g in got]}")
        record["cases"][case] = rec
    for case in cases:  # 1F1B against GPipe on the same mesh
        if case.startswith("pipe:gpipe:"):
            other = case.replace("gpipe", "1f1b")
            if other in record["cases"]:
                a, b = record["cases"][case], record["cases"][other]
                rel = max(_rel(a["losses"], b["losses"]), _rel(a["grad_norms"], b["grad_norms"]))
                fractions[f"{case} vs 1f1b"] = rel / ZERO_REL_TOL
                record["cases"][case]["rel_diff_to_1f1b"] = rel
                log(f"[pipe_onebit] {case} against {other}: largest relative difference "
                    f"{rel:.3e} (tolerance {ZERO_REL_TOL}); peak GiB by rank "
                    f"{[round(x, 2) for x in a['peak_gib']]} against "
                    f"{[round(x, 2) for x in b['peak_gib']]}")
                if rel > ZERO_REL_TOL:
                    failures.append(f"{case} against {other}: relative {rel:.3e}")
    fraction = max(fractions.values())
    record["worst_error_fraction"] = fraction
    log(f"[pipe_onebit] worst_error_fraction={fraction:.3f} (by case: "
        f"{ {k: round(v, 4) for k, v in fractions.items()} })")
    if failures:
        raise RuntimeError(f"pipe_onebit disagrees: {'; '.join(failures)}")
    return launches, record


# the mutant checks. Grouped matmul: a copy that drops one row block's
# contribution (gmm on the wgmma route: the second 128-row tile's products;
# tgmm on both routes: each expert's first row block) must fail the
# moe_kernels phase by far. Block-sparse,
# Evoformer, flash and paged prefill: a copy whose kernel skips the last of
# its loop's items (a LUT column, a group row, a live q- or k-tile) must
# fail its phase by more than MUTANT_MIN_FACTOR x its tolerance. Each
# replacement is (file, old text, new text), the old text found once.
MMA_HDR = "deepspeed_tpu_torch/ops/csrc/mma_sm90.cuh"


def _in(path, pairs):
    return tuple((path, old, new) for old, new in pairs)


GMM_MUTATIONS = _in(GMM_SRC, (
    ("    // out: each consumer warpgroup writes its 64 rows",
     "    if (KIND != kTgmm && x.row0 == kBM)\n"
     "      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;\n"
     "    // out: each consumer warpgroup writes its 64 rows"),
    ("  r_begin = first * bt;", "  r_begin = (first + (lo > first ? 1 : 0)) * bt;"),
))
BSA_MUTATIONS = _in(BSA_SRC, (  # the tensor-core kernel: each warp skips its last LUT column
    ("const int n = a.nvalid[(long long)h * gridDim.y + tile];",
     "const int n = a.nvalid[(long long)h * gridDim.y + tile];\n"
     "  int own_last = -1;  // the last union entry of this warp's row\n"
     "  for (int j = 0; j < n; ++j)\n"
     "    if ((list[j] >> kColBits >> warp) & 1) own_last = j;"),
    ("on[hh] = live && at.j < n && ((at.w >> warp) & 1) &&",
     "on[hh] = live && at.j < n && at.j != own_last && ((at.w >> warp) & 1) &&"),
))
BSA_FP32_MUTATIONS = _in(BSA_SRC, (  # the fp32 kernel skips each row's last LUT column
    ("const int n_keys = nv * a.block;", "const int n_keys = (nv > 0 ? nv - 1 : 0) * a.block;"),
))
EVO_MUTATIONS = _in(EVO_SRC, (  # the tensor-core db2 skips each row chunk's last row
    ("const int n_rows = (int)((long long)(c + 1) * a.n_seq / n_chunks) - row_lo;",
     "const int n_rows = (int)((long long)(c + 1) * a.n_seq / n_chunks) - row_lo - 1;"),
))
EVO_FWD_MUTATIONS = _in(EVO_SRC, (  # the tensor-core forward skips each CTA's last key tile
    ("const int n_kt = (a.R + kBK - 1) / kBK;  // key tiles of the forward's walk",
     "const int n_kt = (a.R + kBK - 1) / kBK - (a.R > kBK);  // key tiles of the forward's walk"),
))
EVO_DQ_MUTATIONS = _in(EVO_SRC, (  # the tensor-core dq skips each CTA's last key tile
    ("const int n_kt = (a.R + kBK - 1) / kBK;  // key tiles of dq's walk",
     "const int n_kt = (a.R + kBK - 1) / kBK - (a.R > kBK);  // key tiles of dq's walk"),
))
EVO_DKDV_MUTATIONS = _in(EVO_SRC, (  # the tensor-core dk/dv skips each head's last query tile
    ("const int n_qt = (a.R + kBQ - 1) / kBQ;  // query tiles of each head",
     "const int n_qt = (a.R + kBQ - 1) / kBQ - (a.R > kBQ);  // query tiles of each head"),
))
FLASH_MUTATIONS = _in(FLASH_SRC, (  # dk/dv skips each CTA's last live q-tile, dq its last live k-tile
    ("const int nqt = qt_hi - qt_lo + 1;", "const int nqt = qt_hi - qt_lo;"),
    ("const int nkt = kt_hi - kt_lo + 1;", "const int nkt = kt_hi - kt_lo;"),
))
FLASH_FWD_MUTATIONS = _in(FLASH_SRC, (  # the forward skips each CTA's last live k-tile
    ("const int n_kt = kt_hi - kt_lo + 1;", "const int n_kt = kt_hi - kt_lo;"),
))
FLASH_DIM_HALF_MUTATIONS = _in(FLASH_SRC, (  # at d 256 dk/dv's second warp of each pair stores
    ("  store_frags<DV, T>(dk_out, ldk, k0 + r0, a.S, dk, a.scale, lane);\n"  # nothing: the
     "  store_frags<DV, T>(dv_out, ldk, k0 + r0, a.S, dv, 1.f, lane);\n",  # upper 128 dims
     "  if (dv0 == 0) {\n"
     "    store_frags<DV, T>(dk_out, ldk, k0 + r0, a.S, dk, a.scale, lane);\n"
     "    store_frags<DV, T>(dv_out, ldk, k0 + r0, a.S, dv, 1.f, lane);\n"
     "  }\n"),
))
PAGED_MUTATIONS = _in(SOURCE, (  # the prefill skips each CTA's last live k-tile
    ("const int n_kt = p_hi > p_lo ? (p_hi - 1) / kKT - kt_lo + 1 : 0;",
     "const int n_kt = p_hi > p_lo ? (p_hi - 1) / kKT - kt_lo : 0;"),
))
V1_TABLE_MUTATIONS = _in(  # the v1 identity table's block base shifted by one block
    "deepspeed_tpu_torch/models/transformer.py", (
        ("cv.view(B * Smax, nkv, d), tables, seq_idx, pos, V1_BLOCK,",
         "cv.view(B * Smax, nkv, d), (tables + 1) % (B * Smax // V1_BLOCK), seq_idx, pos, "
         "V1_BLOCK,"),))
def _zero_stale(group):
    """Rank 1 gathers ``group``'s updated shards into a scratch copy (stages
    1-2): it trains on a stale half of that group from the second step."""
    return _in("deepspeed_tpu_torch/runtime/zero/partition.py", (
        ("comm.all_gather_into_tensor(flat, fg.shard_of(flat, self.rank), group=self.group)",
         f"comm.all_gather_into_tensor(flat if (self.rank, fg.name) != (1, '{group}') else "
         "flat.clone(), fg.shard_of(flat, self.rank), group=self.group)"),))


ZERO_MUTANT_MIN_FACTOR = 30.0  # the zero and remat phases' mutants, against their tolerances
MOE_A2A_MUTATIONS = _in("deepspeed_tpu_torch/models/transformer.py", (  # the return exchange
    ("expert_out = all_to_all(out, group).transpose(0, 1)",            # rotates the slots a rank
     "expert_out = all_to_all(out, group).roll(1, 0).transpose(0, 1)"),))
MOE_EXPERT_GRAD_MUTATIONS = _in("deepspeed_tpu_torch/runtime/zero/partition.py", (
    # each owner keeps its own tokens' share of its experts' gradients
    ("comm.reduce_scatter_tensor(summed, whole, group=ctx.group)",
     "summed.copy_(whole.view(world, *summed.shape)[comm.get_rank(ctx.group)])"),))
REMAT_RNG_MUTATIONS = _in(  # the checkpoint restores no generator before the recompute
    "deepspeed_tpu_torch/runtime/activation_checkpointing/checkpointing.py", (
        ("    gens = _replayed(args)\n", "    gens = []\n"),))
TP_REGION_MUTATIONS = _in(  # the column region's backward sums nothing over the model group
    "deepspeed_tpu_torch/module_inject/layers.py", (
        ("        return inference_all_reduce(grad, group=ctx.group), None\n",
         "        return grad, None\n"),))
TP_KV_MUTATIONS = _in(  # every rank's serving weights (stacked) take rank 0's kv heads
    "deepspeed_tpu_torch/models/transformer.py", (
        ("        return t.narrow(d, self.rank * n, n).clone()",
         "        return t.narrow(d, (0 if stacked and name in ('wk', 'wv') else self.rank) * n, "
         "n).clone()"),))
PIPE_STALE_ACTIVATION_MUTATIONS = _in(  # a stage receives the previous microbatch's activation
    "deepspeed_tpu_torch/runtime/pipe/engine.py", (
        ("                self.inputs[c.buffer_id] = t.requires_grad_()",
         "                self.inputs[c.buffer_id], self._prev_act = (\n"
         "                    t if getattr(self, '_prev_act', None) is None else self._prev_act"
         ").detach().requires_grad_(), t"),))
ONEBIT_SERVER_ERROR_MUTATIONS = _in(  # the server's error is not fed back: it stays 0
    "deepspeed_tpu_torch/runtime/engine.py", (
        ("out, self.onebit_err_w[k], self.onebit_err_s[k] = onebit_allreduce(",
         "out, self.onebit_err_w[k], _ = onebit_allreduce("),))
OFFLOAD_STALE_UPLOAD_MUTATIONS = _in(  # the host updates the masters, uploads nothing
    "deepspeed_tpu_torch/runtime/zero/offload.py", (
        ("p.data.copy_(master.view(p.shape), non_blocking=True)", "pass"),))
HEAD_TILE_MUTATIONS = _in(SOURCE, (  # the decode drops each CTA group's last head tile
    ("  if (p_hi <= p_lo) {  // no live block: zeros, m = -1e30, l = 0",
     "  if (p_hi <= p_lo || (n_ht > 1 && ht == n_ht - 1)) {  // no live block: zeros, m = -1e30, "
     "l = 0"),
))
DECODE_MUTATIONS = _in(SOURCE, (  # the decode skips each split's last live block
    ("const int b1 = j_lo + (int)((long long)(split + 1) * n_live / a.kv_splits);",
     "const int b1 = j_lo + (int)((long long)(split + 1) * n_live / a.kv_splits) - 1;"),
))
MUTANT_MIN_FACTOR = 100.0
MUTANTS = {  # name -> (replacements, phase, the phase's failure text)
    "grouped_matmul": (GMM_MUTATIONS, "moe_kernels", "grouped matmul kernels disagree"),
    "block_sparse": (BSA_MUTATIONS, "sparse_kernels", "block-sparse kernel disagrees"),
    "block_sparse_fp32": (BSA_FP32_MUTATIONS, "sparse_kernels", "block-sparse kernel disagrees"),
    "evoformer": (EVO_MUTATIONS, "evo_kernels", "Evoformer kernels disagree"),
    "evoformer_dkdv": (EVO_DKDV_MUTATIONS, "evo_kernels", "Evoformer kernels disagree"),
    "evoformer_fwd": (EVO_FWD_MUTATIONS, "evo_kernels", "Evoformer kernels disagree"),
    "evoformer_dq": (EVO_DQ_MUTATIONS, "evo_kernels", "Evoformer kernels disagree"),
    "flash": (FLASH_MUTATIONS, "train_kernels", "flash kernels disagree"),
    "flash_fwd": (FLASH_FWD_MUTATIONS, "train_kernels", "flash kernels disagree"),
    "flash_dim_half": (FLASH_DIM_HALF_MUTATIONS, "train_kernels", "flash kernels disagree"),
    "paged_prefill": (PAGED_MUTATIONS, "kernels", "kernels disagree with the plain version"),
    "paged_decode": (DECODE_MUTATIONS, "kernels", "kernels disagree with the plain version"),
    "paged_decode_head_tile": (HEAD_TILE_MUTATIONS, "kernels",
                               "kernels disagree with the plain version"),
    "v1_table": (V1_TABLE_MUTATIONS, "v1", "v1 logits disagree"),
    "zero_gather": (_zero_stale("head"), "zero", "zero disagrees"),
    "zero_block": (_zero_stale("block0"), "zero", "zero disagrees"),
    "moe_a2a": (MOE_A2A_MUTATIONS, "moe_zero", "moe_zero disagrees"),
    "moe_expert_grad": (MOE_EXPERT_GRAD_MUTATIONS, "moe_zero", "moe_zero disagrees"),
    "remat_rng": (REMAT_RNG_MUTATIONS, "remat", "remat disagrees"),
    "tp_region": (TP_REGION_MUTATIONS, "tp", "tp disagrees"),
    "tp_kv": (TP_KV_MUTATIONS, "tp", "tp disagrees"),
    "offload_stale_upload": (OFFLOAD_STALE_UPLOAD_MUTATIONS, "offload", "offload disagrees"),
    "pipe_stale_activation": (PIPE_STALE_ACTIVATION_MUTATIONS, "pipe_onebit",
                              "pipe_onebit disagrees"),
    "onebit_server_error": (ONEBIT_SERVER_ERROR_MUTATIONS, "pipe_onebit",
                            "pipe_onebit disagrees"),
}


# the attention kernels' ablations (``--ablation``): each undoes one design
# choice of the flash kernels (forward and backward) or the paged prefill.
_SINGLE = _in(MMA_HDR, (  # a template switch that skips the lo product of a split pair
    ("template <int D, typename T, int LDS = Tile16<D>::LDS, int KC = 4>\n"
     "__device__ __forceinline__ void mma_wm(",
     "template <int D, typename T, int LDS = Tile16<D>::LDS, bool kLo = true, int KC = 4>\n"
     "__device__ __forceinline__ void mma_wm("),
    ("      mma16816(t0, w.lo[c], b[0], b[1], T());",
     "      if (kLo) mma16816(t0, w.lo[c], b[0], b[1], T());"),
    ("      mma16816(t1, w.lo[c], b[2], b[3], T());",
     "      if (kLo) mma16816(t1, w.lo[c], b[2], b[3], T());"),
))
ABLATIONS = {
    # the backward's tile index in blockIdx.x (heavy-first only within one
    # head), not blockIdx.y (heavy-first across the whole grid)
    "grid_per_head": _in(FLASH_SRC, (
        ("const int qt = gridDim.y - 1 - blockIdx.y, h = blockIdx.x, b = blockIdx.z;",
         "const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;"),
        ("const int kvh = blockIdx.x, kt = blockIdx.y, b = blockIdx.z;",
         "const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;"),
        ("grid = dim3(a.nkv, (a.S + kBK - 1) / kBK, a.B);",
         "grid = dim3((a.S + kBK - 1) / kBK, a.nkv, a.B);"),
        ("grid = dim3(a.nq, (a.S + kBQ - 1) / kBQ, a.B);",
         "grid = dim3((a.S + kBQ - 1) / kBQ, a.nq, a.B);"),
    )),
    # the paged prefill's tiles in token order (the latest, heaviest tiles
    # of a causal prefill dispatched last), not reversed
    "prefill_tiles_in_order": _in(SOURCE, (
        ("const int kvh = blockIdx.x, tile = gridDim.y - 1 - blockIdx.y, c0 = kKT * blockIdx.z;",
         "const int kvh = blockIdx.x, tile = blockIdx.y, c0 = kKT * blockIdx.z;"),
    )),
    # the same for the flash forward
    "fwd_grid_per_head": _in(FLASH_SRC, (
        ("const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;",
         "const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;"),
        ("grid = dim3(a.nq, (a.S - 1) / kBQ + 1, a.B);",
         "grid = dim3((a.S - 1) / kBQ + 1, a.nq, a.B);"),
    )),
    # the per-element causal / window mask on every tile, not only on tiles
    # that cross the band or S (all three flash kernels)
    "mask_every_tile": _in(FLASH_SRC, (("  if (q0 + kBQ > a.S || k0 + kBK > a.S) return false;",
                                        "  return false;"),)),
    # the mma steps accumulate straight into the long-run accumulators, not
    # each tile pair from zero first (the tensor cores' fp32 sums truncate;
    # every P . V, dv, dk and dq product)
    "one_level_acc": _in(MMA_HDR, (
        ("    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};",
         "    float(&t0)[4] = out[n];\n    float(&t1)[4] = out[n + 1];"),
        ("      out[n][e] += t0[e];\n      out[n + 1][e] += t1[e];\n", ""),
    )),
    # one product's P or dS as one rounding instead of the split pair: dq's
    # dS, dv's P, dk's dS, the forward's P, the prefill's P
    "single_dq": _SINGLE + _in(FLASH_SRC, (("mma_wm<DV, T, LDS>(dq, ds, sK + dv0, lane);",
                                            "mma_wm<DV, T, LDS, false>(dq, ds, sK + dv0, lane);"),)),
    "single_dv": _SINGLE + _in(FLASH_SRC, (("mma_wm<DV, T, LDS>(dv, p, sdOc + dv0, lane);",
                                            "mma_wm<DV, T, LDS, false>(dv, p, sdOc + dv0, lane);"),)),
    "single_dk": _SINGLE + _in(FLASH_SRC, (("mma_wm<DV, T, LDS>(dk, ds, sQc + dv0, lane);",
                                            "mma_wm<DV, T, LDS, false>(dk, ds, sQc + dv0, lane);"),)),
    "fwd_single_p": _SINGLE + _in(FLASH_SRC, (("mma_wm<DV, T, LDS>(acc, p, sV + dv0, lane);",
                                               "mma_wm<DV, T, LDS, false>(acc, p, sV + dv0, lane);"),)),
    "prefill_single_p": _SINGLE + _in(SOURCE, (("mma_wm<DV, T, LDS>(acc, pf, sV + dv0, lane);",
                                                "mma_wm<DV, T, LDS, false>(acc, pf, sV + dv0, lane);"),)),
    # the grouped matmul's TMA ring two stages deep, not three: loads one
    # stage ahead of the products, not two
    "gmm_ring2": _in(GMM_SRC, (("constexpr int kStages = 3;", "constexpr int kStages = 2;"),)),
    # one CTA per output tile, not a persistent CTA per SM walking the tiles
    # (nothing overlaps one tile's epilogue with the next one's loads)
    "gmm_cta_per_tile": _in(GMM_SRC, (("constexpr bool kPersistent = true;",
                                       "constexpr bool kPersistent = false;"),)),
    # the tensor-core db2 with each group's rows in one chunk (the first
    # version's grid, nt^2 h G CTAs), not split across the card
    "evo_db2_one_chunk": _in(EVO_PY, (
        ("    return max(1, min(n_seq, -(-DB2_CTAS_PER_SM * SMS // per_chunk)))",
         "    return 1"),)),
    # the tensor-core forward and dq with two rows n of a group a CTA at d
    # 32, sharing each staged pair-bias tile, not one
    "evo_bias_two_rows": _in(EVO_SRC, (("constexpr int kBiasRows = 1;",
                                        "constexpr int kBiasRows = 2;"),)),
}
# flash dk/dv walking each 64-query item in chunks of 32 queries, not 16
# (fewer reloads of a warp's K and V fragments; spills at fp16 d 96 / 128
# and at d 256)
ABLATIONS["dkdv_chunk32"] = _in(FLASH_SRC, (
    ("constexpr int kQC = 16;", "constexpr int kQC = 32;"),
))
# the tensor-core block-sparse forward with each warp walking its own row's
# LUT columns through its own ring, not a CTA's four warps the union of
# their rows' columns (each staged K/V slice shared)
ABLATIONS["block_sparse_per_warp"] = _in(BSA_SRC, (
    ("constexpr bool kUnionWalk = true;", "constexpr bool kUnionWalk = false;"),
))
GMM_HDR = "deepspeed_tpu_torch/ops/csrc/wgmma_sm90.cuh"
PAGED_PY = "deepspeed_tpu_torch/ops/paged_attention.py"
# the decode split over the table's capacity (split s owns blocks [s per,
# (s + 1) per), per = ceil(max_blocks / splits), as the TPU grid and the first
# version of the kernel), in the kernel and in its plain partials alike
ABLATIONS["decode_capacity_split"] = _in(SOURCE, (
    ("  const int b0 = j_lo + (int)((long long)split * n_live / a.kv_splits);\n"
     "  const int b1 = j_lo + (int)((long long)(split + 1) * n_live / a.kv_splits);",
     "  const int per = (a.max_blocks + a.kv_splits - 1) / a.kv_splits;\n"
     "  const int b0 = max(j_lo, split * per), b1 = max(b0, min(j_hi + 1, (split + 1) * per));"),
)) + _in(PAGED_PY, (
    ("    return j_lo + s * n_live // kv_splits, j_lo + (s + 1) * n_live // kv_splits",
     "    per = -(-max_blocks // kv_splits)\n"
     "    b0 = torch.maximum(j_lo, s * per)\n"
     "    return b0, torch.maximum(b0, torch.minimum(j_hi + 1, (s + 1) * per))"),
))
# the decode's grid with the token fastest (a token's kv heads 32 CTAs apart
# at the main shape), not its kv heads side by side
ABLATIONS["decode_token_major_grid"] = _in(SOURCE, (
    ("  const int kvh = kvt % a.nkv, tok = kvt / a.nkv;",
     "  const int kvh = kvt / a.T, tok = kvt % a.T;"),
))
# each decode copy instruction over 16 slots, a lane pair a slot (32 bytes of
# each row), not over whole rows
ABLATIONS["decode_pair_chunks"] = _in(SOURCE, (
    ("      const int c = min(i * 32 + lane, kChunks - 1);",
     "      const int c = (lane / 2) * CH + min(2 * i + (lane & 1), CH - 1);"),
    ("      if (i * 32 + lane < kChunks) {", "      if (2 * i + (lane & 1) < CH) {"),
))
# the decode's int8 rows widened by conversion instructions (int8 -> fp32 ->
# bf16, a quarter of the ALU rate, as the prefill), not by the exact
# integer and fp32-add path of widen16
ABLATIONS["decode_widen_cvt"] = _in(SOURCE, (
    ("        widen16(v16, w);\n",
     "        const int8_t* b8 = reinterpret_cast<const int8_t*>(&v16);\n"
     "#pragma unroll\n"
     "        for (int e = 0; e < 8; ++e)\n"
     "          w[e] = pack2(__float2bfloat16((float)b8[2 * e]), "
     "__float2bfloat16((float)b8[2 * e + 1]));\n"),
))
# each decode warp's ring three stages deep (two steps in flight; 2 CTAs an SM
# by shared memory at d 128), not two
ABLATIONS["decode_ring3"] = _in(SOURCE, (
    ("constexpr int kDecStages = 2;", "constexpr int kDecStages = 3;"),
))


def _ablation_phases(name):
    """The phases that time an ablation: ``moe_kernels`` for the grouped
    matmul's sources, ``sparse_kernels`` for the block-sparse forward's,
    ``evo_kernels`` for the Evoformer's, ``kernels`` for the paged decode's,
    ``kernels,train_kernels`` for the other attention kernels'."""
    files = {p for p, _, _ in ABLATIONS[name]}
    if files <= {GMM_SRC, GMM_HDR}:
        return "moe_kernels"
    if files <= {BSA_SRC}:
        return "sparse_kernels"
    if name.startswith("decode_"):  # the paged decode's ablations
        return "kernels"
    return "evo_kernels" if files <= {EVO_SRC, EVO_PY} else "kernels,train_kernels"


def _patched_copy(kind, name, replacements):
    """Copy the package and this script into build/<kind>/<name> and apply
    ``replacements`` ((file, old, new), each old text found exactly once in
    the copy's file). Returns the copy's directory, or None when a text is
    not found once."""
    import shutil

    dst = os.path.join(HERE, "build", kind, name)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(os.path.join(HERE, "deepspeed_tpu_torch"),
                    os.path.join(dst, "deepspeed_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.abspath(__file__), dst)
    for path, old, new in replacements:
        f = os.path.join(dst, path)
        text = open(f).read()
        if text.count(old) != 1:
            log(f"[{kind}] {name}: the text to replace is not found once in {path}: {old!r}")
            return None
        with open(f, "w") as out:
            out.write(text.replace(old, new))
    return dst


def _worst_error_fraction(stdout, phase):
    import re

    found = re.findall(rf"\[{phase}\].*worst_error_fraction=([0-9.eE+-]+|inf)", stdout)
    return float(found[-1]) if found else None


def _run_one_mutant(name):
    """Run ``--phases build,<phase>`` in a mutated copy (build/mutant/<name>)
    and return whether that run failed as it must."""
    mutations, phase, failure = MUTANTS[name]
    dst = _patched_copy("mutant", name, mutations)
    if dst is None:
        return False
    proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", f"build,{phase}"],
                          cwd=dst, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith(f"[{phase}]") or "disagree" in line:
            log(f"[mutant] {name}: {line[:4000]}")
    caught = proc.returncode != 0 and failure in proc.stdout
    # a wrong identity table moves whole blocks of context: the logits'
    # relative L2 is then of order 1, some 20x its tolerance, not 100x; a
    # stale half of a group moves the losses by what one step moves them
    if phase not in ("moe_kernels", "v1"):
        least = (ZERO_MUTANT_MIN_FACTOR if phase in ("zero", "moe_zero", "remat", "tp",
                                                      "offload", "pipe_onebit") else
                 MUTANT_MIN_FACTOR)
        factor = _worst_error_fraction(proc.stdout, phase) or 0.0
        log(f"[mutant] {name}: caught at {factor:.1f}x the tolerance (must exceed "
            f"{least:.0f}x)")
        caught = caught and factor > least
    log(f"[mutant] {name}: the mutated kernels' run exited {proc.returncode}: "
        f"{'caught, as it must be' if caught else 'NOT caught'}")
    return caught


def run_mutant(which="all"):
    """Every mutant of ``MUTANTS`` (or the comma-separated names in
    ``which``) must be caught. Returns an exit code."""
    names = list(MUTANTS) if which == "all" else [n for n in which.split(",") if n]
    if set(names) - set(MUTANTS):
        log(f"[mutant] unknown mutants {sorted(set(names) - set(MUTANTS))}")
        return 1
    results = {name: _run_one_mutant(name) for name in names}
    return 0 if all(results.values()) else 1


_ATTN_BUILD = ("from deepspeed_tpu_torch.ops import flash_attention as fa, paged_attention as pa; "
               "fa.kernel_build(); pa.kernel_build()")
_GMM_BUILD = "from deepspeed_tpu_torch.ops import grouped_matmul as gm; gm.kernel_build()"
_EVO_BUILD = "from deepspeed_tpu_torch.ops import evoformer_attention as ev; ev.kernel_build()"
_BSA_BUILD = "from deepspeed_tpu_torch.ops import block_sparse_attention as bs; bs.kernel_build()"


def _num(pattern, text):
    import re

    found = re.findall(pattern, text)
    return float(found[-1]) if found else None


def _gmm_times(stdout):
    """The grouped matmul's main-shape times and largest error fractions
    printed by a ``moe_kernels`` run (this script's or the parent's)."""
    return {"gmm_up_ms": _num(r"\] gmm up \(K 4096, N 14336\).*?: ([0-9.]+) ms", stdout),
            "gmm_down_ms": _num(r"\] gmm down \(K 14336, N 4096\).*?: ([0-9.]+) ms", stdout),
            "gmm_dx_ms": _num(r"\] gmm dx trans_b \(K 14336, N 4096\).*?: ([0-9.]+) ms", stdout),
            "tgmm_ms": _num(r"\] tgmm dw \(K 4096, N 14336\).*?: ([0-9.]+) ms", stdout),
            "gmm_error_fraction": _num(r"over all cases: gmm ([0-9.]+) of", stdout),
            "tgmm_error_fraction": _num(r"over all cases: gmm .*?, tgmm ([0-9.]+) \(", stdout)}


def _flash_main_times(stdout):
    """The flash kernels' times at the training shape (B 1, S 4096, 32/8,
    d 128) printed by a ``train_kernels`` run (this script's or the
    parent's)."""
    return {f"{name}_ms": _num(rf"\[train_kernels\] {name} B=1 S=4096 [^:]*: ([0-9.]+) ms", stdout)
            for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}


def _decode_times(stdout):
    """The paged decode's main-shape times printed by a ``kernels`` run
    (this script's or the parent's): both routes, bf16 and int8, and the
    device times with the host queued ahead; this tree's also the split
    kernel and the merge apart; the prefill's (bf16 pools), timed and
    queued."""
    r = {}
    for i8 in (False, True):
        sfx = "_int8" if i8 else ""
        line = rf"\] decode S=\d+ ctx=\d+ int8={i8} splits=\d+: "
        r[f"decode{sfx}_ms"] = _num(line + r"paged_decode ([0-9.]+) ms", stdout)
        r[f"decode_split{sfx}_ms"] = _num(line + r".*?paged_decode_split ([0-9.]+) ms", stdout)
        r[f"split_kernel{sfx}_ms"] = _num(
            rf"\] decode split route apart, int8={i8}: split kernel ([0-9.]+) ms", stdout)
        r[f"merge{sfx}_ms"] = _num(
            rf"\] decode split route apart, int8={i8}: .*?merge kernel ([0-9.]+) ms", stdout)
    dev = r"\] device time per call .*?"
    for key, name in (("decode", "paged_decode"), ("decode_split", "paged_decode_split")):
        r[f"{key}_device_ms"] = _num(dev + rf"{name} ([0-9.]+) /", stdout)
        r[f"{key}_int8_device_ms"] = _num(dev + rf"{name} [0-9.]+ / ([0-9.]+) ms", stdout)
    r["prefill_ms"] = _num(r"\] prefill T=512 int8=False .*?paged_prefill ([0-9.]+) ms", stdout)
    r["prefill_device_ms"] = _num(dev + r"paged_prefill ([0-9.]+) /", stdout)
    r["paged_error_fraction"] = _worst_error_fraction(stdout, "kernels")
    return r


def _e2e_numbers(stdout):
    """The serving path's numbers printed by an ``e2e`` run: TTFT p50,
    decode tok/s, the decode profile's wall and device ms per step, device
    kernels per step and idle share."""
    prof = r"\[e2e\] decode profile, .*?"
    return {"ttft_p50_ms": _num(r"\[e2e\] served .*?TTFT p50 ([0-9.]+) ms", stdout),
            "decode_tok_s": _num(r"\[e2e\] served .*?decode ([0-9.]+) tok/s", stdout),
            "decode_step_wall_ms": _num(prof + r"wall ([0-9.]+) ms/step unprofiled", stdout),
            "decode_step_device_ms": _num(prof + r"device busy ([0-9.]+) ms/step", stdout),
            "decode_step_kernels": _num(prof + r"device kernels ([0-9.]+) per step", stdout),
            "decode_idle_pct": _num(prof + r"device idle ([0-9.]+)% of the unprofiled", stdout),
            "put_512_wall_ms": _num(r"\[e2e\] prefill profile, .*?wall ([0-9.]+) ms unprofiled",
                                    stdout)}


def _evo_times(stdout):
    """The Evoformer kernels' main-shape times (both routes; the parent's
    script printed the tensor-core route's dk/dv and db2 and the CUDA-core
    forward and dq under the unsuffixed names), the block time and the
    largest error fraction printed by ``evo_kernels`` / ``evo_path`` runs
    (this script's or the parent's)."""
    return {f"{k}{sfx}_ms": _num(rf"\] {k}{sfx} msa_row .*?: ([0-9.]+) ms", stdout)
            for k in ("evo_fwd", "evo_bwd_dq", "evo_bwd_dkdv", "evo_bwd_db1", "evo_bwd_db2")
            for sfx in ("", "_fp32")} | {
        "evo_error_fraction": _worst_error_fraction(stdout, "evo_kernels"),
        "evo_block_ms": _num(r"\[evo_path\] block forward \+ backward .*?median ([0-9.]+) ms",
                             stdout)}


def _sparse_times(stdout):
    """The block-sparse forward's main-shape times on both routes (the
    parent's script printed one kernel, the CUDA-core one, under the
    unsuffixed name), SDPA's with the mask, the sparse training step and the
    largest error fraction printed by ``sparse_kernels`` / ``sparse_train``
    runs (this script's or the parent's)."""
    import re

    return {f"block_sparse_fwd{sfx}_ms": _num(rf"\] block_sparse_fwd{sfx} B=\d+ .*?: ([0-9.]+) ms",
                                              stdout) for sfx in ("", "_fp32")} | {
        "block_sparse_sdpa_ms": _num(r"\] block_sparse_fwd B=\d+ .*?sdpa with the layout as a "
                                     r"boolean mask ([0-9.]+) ms", stdout),
        "sparse_error_fraction": _worst_error_fraction(stdout, "sparse_kernels"),
        "block_sparse_ptxas": (re.findall(r"\] d 64 / 128 on the tensor cores, .*?: (\[.*?\])",
                                          stdout) or [None])[-1],
        "sparse_step_ms": _num(r"\[sparse_train\] step time median ([0-9.]+) ms", stdout),
        "sparse_idle_pct": _num(r"\[sparse_train\] profiled step: .*?device idle ([0-9.]+)%",
                                stdout)}


def run_ablation(which="all"):
    """The unchanged sources (``base``) and each of ``ABLATIONS`` (or the
    comma-separated names in ``which``) in a copy under build/ablation/;
    the copies' kernels are built in parallel, then each copy runs the
    phases that time it (``_ablation_phases``; base runs all of them) in
    turns, base and the ablations and then the same in reverse, so every
    version is timed twice on one card. Prints one line per run and, last,
    one JSON object with every run. Returns an exit code: 1 when a copy
    does not build or a run prints no times (an ablation that misses the
    tolerance is a result, not a failure)."""
    chosen = list(ABLATIONS) if which == "all" else [n for n in which.split(",") if n]
    unknown = sorted(set(chosen) - set(ABLATIONS))
    if unknown:
        log(f"[ablation] unknown ablations {unknown}; known: {list(ABLATIONS)}")
        return 1
    phases = {n: _ablation_phases(n) for n in chosen}
    phases["base"] = ",".join(sorted(set(",".join(phases.values()).split(",")),
                                     key=PHASES.index))
    names = ["base", *chosen]
    dirs = {n: _patched_copy("ablation", n, ABLATIONS.get(n, ())) for n in names}
    if None in dirs.values():
        return 1

    def build(n):
        parts = ([_ATTN_BUILD] if "kernels" in phases[n].split(",") else []) + (
            [_GMM_BUILD] if "moe_kernels" in phases[n] else []) + (
            [_EVO_BUILD] if "evo_kernels" in phases[n] else []) + (
            [_BSA_BUILD] if "sparse_kernels" in phases[n] else [])
        return "; ".join(parts)

    procs = {n: subprocess.Popen([sys.executable, "-c", build(n)], cwd=d, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items()}
    failed = False
    for n, p in procs.items():
        text = p.communicate(timeout=900)[0]
        if p.returncode:
            log(f"[ablation] {n}: build failed\n{text[-3000:]}")
            failed = True
    if failed:
        return 1
    runs = []
    for n in names + names[::-1]:
        proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", phases[n]],
                              cwd=dirs[n], capture_output=True, text=True, timeout=900)
        out = proc.stdout
        r = {"name": n, "rc": proc.returncode}
        need = []
        if "train_kernels" in phases[n]:
            r.update({
                "fwd_ms": _num(r"\] flash_fwd .*?: ([0-9.]+) ms", out),
                "dkdv_ms": _num(r"\] flash_bwd_dkdv .*?: ([0-9.]+) ms", out),
                "dq_ms": _num(r"\] flash_bwd_dq .*?: ([0-9.]+) ms", out),
                "prefill_ms": _num(r"\] prefill T=\d+ int8=False .*?paged_prefill ([0-9.]+) ms",
                                   out),
                "prefill_device_ms": _num(r"\] device time per call .*?paged_prefill ([0-9.]+) /",
                                          out),
                "sdpa_fwd_ms": _num(r"\] flash_fwd .*sdpa forward ([0-9.]+) ms", out),
                "sdpa_bwd_ms": _num(r"\] flash_bwd_dq .*sdpa backward ([0-9.]+) ms", out),
                "flash_worst_error_fraction": _worst_error_fraction(out, "train_kernels"),
                "paged_worst_error_fraction": _worst_error_fraction(out, "kernels")})
            need += ["fwd_ms", "dkdv_ms", "dq_ms", "prefill_ms"]
        if "kernels" in phases[n].split(","):
            r.update(_decode_times(out))
            need += ["decode_ms", "decode_split_ms"]
        if "moe_kernels" in phases[n]:
            r.update(_gmm_times(out))
            need += ["gmm_up_ms", "tgmm_ms"]
        if "evo_kernels" in phases[n]:
            r.update({k: v for k, v in _evo_times(out).items() if k != "evo_block_ms"})
            need += ["evo_fwd_ms", "evo_bwd_dq_ms", "evo_bwd_db2_ms", "evo_bwd_dkdv_ms"]
        if "sparse_kernels" in phases[n]:
            r.update({k: v for k, v in _sparse_times(out).items() if k.startswith(
                ("block_sparse", "sparse_error"))})
            need += ["block_sparse_fwd_ms", "block_sparse_fwd_fp32_ms"]
        runs.append(r)
        log(f"[ablation] {n} ({phases[n]}): "
            + ", ".join(f"{k} {v}" for k, v in r.items() if k not in ("name", "rc"))
            + f" (exit {r['rc']})")
        failed = failed or any(r.get(k) is None for k in need)
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "runs": runs}), flush=True)
    return 1 if failed else 0


# runs this script's phase_e2e on the package of the tree in the current
# directory (imported first, so this script's own tree never shadows it)
_E2E_IN_TREE = ("import sys, importlib.util as u; sys.path.insert(0, '.'); "
                "import deepspeed_tpu_torch; "
                "spec = u.spec_from_file_location('chip_smoke_harness', {path!r}); "
                "m = u.module_from_spec(spec); spec.loader.exec_module(m); "
                "m.log('[e2e] package ' + deepspeed_tpu_torch.__file__); m.phase_e2e()")


def run_versus(other, phases):
    """Time this tree against another checkout of the repository
    (``other``, e.g. a ``git archive`` of the parent commit under
    build/parent): ``--phases build`` in both at once (each tree's own
    script and kernels), then ``phases`` in the order other, this, this,
    other: every phase but ``e2e`` through the tree's own script, ``e2e``
    through this script's ``phase_e2e`` on the tree's package, one process
    each, so that each tree is timed twice on one card. Prints each run's
    paged decode times, serving numbers, grouped matmul, Evoformer and
    block-sparse times, MoE step, Evoformer block, block-sparse step and top
    device ops, and last one JSON object of every run. Returns an exit code: 1 when a build or a run fails."""
    other = os.path.abspath(other)
    dirs = {"other": other, "this": HERE}
    builds = {n: subprocess.Popen([sys.executable, "chip_smoke.py", "--phases", "build"], cwd=d,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for n, d in dirs.items()}
    failed = False
    for n, proc in builds.items():
        text = proc.communicate(timeout=900)[0]
        for line in text.splitlines():
            if line.startswith("[build]") and not line.startswith("[build]   ") and (
                    "nvcc" in line or "grouped" in line or "paged attention" in line):
                log(f"[versus] {n}: {line}")
        if proc.returncode:
            log(f"[versus] {n}: build failed\n{text[-3000:]}")
            failed = True
    if failed:
        return 1
    own = [p for p in phases if p != "e2e"]
    runs = []
    for n in ("other", "this", "this", "other"):
        out, rc = "", 0
        if own:
            proc = subprocess.run([sys.executable, "chip_smoke.py", "--phases", ",".join(own)],
                                  cwd=dirs[n], capture_output=True, text=True, timeout=1800)
            out, rc = proc.stdout, proc.returncode
        if "e2e" in phases:
            code = _E2E_IN_TREE.format(path=os.path.abspath(__file__))
            proc = subprocess.run([sys.executable, "-c", code], cwd=dirs[n], capture_output=True,
                                  text=True, timeout=1800)
            out, rc = out + proc.stdout + proc.stderr[-3000:], rc or proc.returncode
        r = {"tree": n, "rc": rc, **_decode_times(out), **_e2e_numbers(out), **_gmm_times(out),
             **_flash_main_times(out),
             "train_step_ms": _num(r"\[train\] step time median ([0-9.]+) ms", out),
             "moe_step_ms": _num(r"\[moe_train\] step time median ([0-9.]+) ms", out),
             "moe_idle_pct": _num(r"\[moe_train\] profiled step: .*?device idle ([0-9.]+)%", out),
             **_evo_times(out), **_sparse_times(out),
             "evo_idle_pct": _num(r"\[evo_path\] profiled block: .*?idle ([0-9.]+)%", out),
             "top_ops": [line.split("]", 1)[1].strip() for line in out.splitlines()
                         if line.startswith(("[e2e]   ", "[moe_train]   ", "[evo_path]   ",
                                             "[sparse_train]   "))]}
        r = {k: v for k, v in r.items() if v is not None}
        runs.append(r)
        log(f"[versus] {n} ({dirs[n]}): "
            + ", ".join(f"{k} {v}" for k, v in r.items() if k not in ("tree", "rc", "top_ops"))
            + f" (exit {r['rc']})")
        for line in r["top_ops"]:
            log(f"[versus] {n}   {line}")
        if rc:
            log(f"[versus] {n}: failed\n{out[-3000:]}")
            failed = True
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "other": other, "phases": phases,
                      "runs": runs}), flush=True)
    return 1 if failed else 0


PHASES = ("build", "kernels", "train_kernels", "moe_kernels", "sparse_kernels", "e2e", "train",
          "remat", "eager", "zero", "moe_zero", "tp", "moe_train", "sparse_train", "evo_kernels",
          "evo_path", "v1", "hybrid", "prefix_sample", "families", "families_train", "offload",
          "pipe_onebit")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES} (default: all; a subset prints no "
                         f"result lines)")
    ap.add_argument("--mutant", nargs="?", const="all", default=None, metavar="NAMES",
                    help=f"run the mutant checks alone ({tuple(MUTANTS)}, or the comma-separated "
                         f"NAMES): each must be caught")
    ap.add_argument("--ablation", nargs="?", const="all", default=None, metavar="NAMES",
                    help=f"time the kernels against their ablations {tuple(ABLATIONS)} (all, or "
                         f"the comma-separated NAMES), each version twice in turns")
    ap.add_argument("--versus", metavar="DIR",
                    help="time --phases (without build; default kernels,e2e) in this tree and in "
                         "the checkout DIR, in the order DIR, this, this, DIR")
    # one rank of the zero phase, started by phase_zero
    ap.add_argument("--zero-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--zero-layers", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--zero-stages", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--zero-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the deepspeed_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if args.zero_rank is not None:
        cases = args.zero_stages.split(",")
        if args.zero_stages.startswith("tp:"):  # a tp rank
            _tp_rank_run(args.zero_layers, cases, args.zero_out)
        elif args.zero_stages.startswith(("dp:", "onebit:", "pipe:")):  # a pipe_onebit rank
            _pipe_onebit_rank_run(cases, args.zero_out)
        elif ":" in args.zero_stages:  # a moe_zero rank: impl:stage cases
            _moe_zero_rank_run(args.zero_layers, [(c.split(":")[0], int(c.split(":")[1]))
                                                  for c in cases], args.zero_out)
        else:
            _zero_rank_run(args.zero_layers, cases, args.zero_out)
        return 0
    if args.mutant:
        return run_mutant(args.mutant)
    if args.ablation:
        return run_ablation(args.ablation)
    if args.versus:
        chosen = [p for p in phases if p != "build"]
        return run_versus(args.versus, chosen if tuple(phases) != PHASES else ["kernels", "e2e"])
    t_all = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} visible; {smi}")
    fns = {"build": phase_build, "kernels": phase_kernels, "train_kernels": phase_train_kernels,
           "moe_kernels": phase_moe_kernels, "sparse_kernels": phase_sparse_kernels,
           "e2e": phase_e2e, "train": phase_train, "remat": phase_remat, "eager": phase_eager,
           "zero": phase_zero,
           "moe_zero": phase_moe_zero, "tp": phase_tp, "moe_train": phase_moe_train,
           "sparse_train": phase_sparse_train, "evo_kernels": phase_evo_kernels,
           "evo_path": phase_evo_path, "v1": phase_v1, "hybrid": phase_hybrid,
           "prefix_sample": phase_prefix_sample, "families": phase_families,
           "families_train": phase_families_train, "offload": phase_offload,
           "pipe_onebit": phase_pipe_onebit}
    failed = []
    out = {}
    for name in PHASES:
        if name not in phases:
            continue
        t0 = time.perf_counter()
        try:
            out[name] = fns[name]()
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
        except Exception:  # noqa: BLE001 -- report every phase, fail at the end
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s")
            traceback.print_exc(file=sys.stdout)
            if name == "build":
                break
    log(f"[done] {time.perf_counter() - t_all:.1f}s total; failed phases: {failed or 'none'}")
    if failed:
        return 1
    if tuple(phases) != PHASES:
        return 0
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    v1_launches, v1 = out["v1"]
    hybrid_launches, hybrid = out["hybrid"]
    kernels = [{"name": name, "route": "cuda", "source": SOURCE, "replaces": KERNELS[name],
                "launches": int(out["e2e"][name]), "v1_launches": int(v1_launches[name]),
                "hybrid_launches": int(hybrid_launches[name]),
                **({"v1_block128": v1["kernels_block128"][name]}
                   if name in v1["kernels_block128"] else {}),
                "max_abs_err": m["err"],
                **{k: m[k] for k in keys},
                **{k: m[k] for k in ("device_ms", "descriptors_ms", "flash_fwd_same_work_ms",
                                     "kernel_ms", "kernel_device_ms", "merge_ms",
                                     "partials_error_fraction", "splits", "family_shapes")
                   if k in m},
                "int8": {k: m["int8"][k] for k in (*keys[:4], "device_ms")}
                | {"max_abs_err": m["int8"]["err"]}}
               for name, m in out["kernels"].items()]
    launches, adam_full = out["train"]
    remat_launches, remat = out["remat"]
    eager_launches, eager = out["eager"]
    zero_launches, zero = out["zero"]
    moe_zero_launches, moe_zero = out["moe_zero"]
    tp_launches, tp = out["tp"]
    prefix_launches, prefix = out["prefix_sample"]
    families_launches, families = out["families"]
    families_train_launches, families_train = out["families_train"]
    offload_launches, offload = out["offload"]
    pipe_onebit_launches, pipe_onebit = out["pipe_onebit"]
    for entry in kernels:  # the paged kernels' launches per rank on the tp serving path
        entry["tp_launches"] = tp_launches[entry["name"]]
        entry["prefix_sample_launches"] = {run: int(n[entry["name"]])
                                           for run, n in prefix_launches.items()}
        entry["families_launches"] = {run: int(n[entry["name"]])
                                      for run, n in families_launches.items()}
    for name, m in out["train_kernels"].items():
        src, replaces = TRAIN_KERNELS[name]
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": int(launches[name]), "hybrid_launches": int(hybrid_launches[name]),
                 "remat_launches_a_step": {k: v[name] for k, v in remat_launches.items()
                                           if k != "moe"},
                 "eager_launches": int(eager_launches[name]),
                 "zero_launches": zero_launches[name], "zero": zero,
                 "moe_zero_launches": moe_zero_launches[name],
                 "tp_launches": tp_launches[name],
                 "families_train_launches": {run: int(n[name])
                                             for run, n in families_train_launches.items()},
                 "max_abs_err": m["err"], **{k: m[k] for k in keys},
                 **({"family_shapes": m["family_shapes"]} if "family_shapes" in m else {})}
        if name in offload_launches["device"]:  # the flash kernels
            entry["offload_launches"] = {run: int(n[name]) for run, n in offload_launches.items()}
        entry["pipe_onebit_launches"] = {case: n.get(name, [0] * pipe_onebit["world"])
                                         for case, n in pipe_onebit_launches.items()}
        if name == "flash_fwd":
            entry["v1_launches"] = int(v1_launches[name])
            entry["families_train"] = families_train
            entry["offload"] = offload
        if name == "fused_adam":
            entry["full_set"] = adam_full
        if name == "flash_fwd":
            entry["remat"], entry["eager"] = remat, eager
            entry["pipe_onebit"] = pipe_onebit
        kernels.append(entry)
    moe_launches, moe_step = out["moe_train"]
    for name, m in out["moe_kernels"].items():
        src, replaces = MOE_KERNELS[name]
        extra = {k: m[k] for k in ("library", "t_pad", "routed_rows", "calls", "serving_module",
                                   "hgmma_in_sass", "worst_error_fraction", "dw_cast_ms")
                 if k in m}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": int(moe_launches[name]),
                        "moe_zero_launches": moe_zero_launches[name],
                        "remat_moe_launches": int(remat_launches["moe"][name]),
                        "max_abs_err": m["err"],
                        **{k: m[k] for k in keys}, **extra})
    kernels[-1]["moe_train_step"] = moe_step
    kernels[-1]["moe_zero"] = moe_zero
    sparse_launches, sparse_step = out["sparse_train"]
    for name, m in out["sparse_kernels"].items():
        src, replaces = SPARSE_KERNELS[name]
        extra = {k: m[k] for k in ("library", "visible_pairs", "densest_row", "backward_ms",
                                   "backward_peak_gib", "fp32_route")}
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": int(sparse_launches[name]), "max_abs_err": m["err"],
                        **{k: m[k] for k in keys}, **extra, "sparse_train_step": sparse_step})
    evo_launches, evo_block = out["evo_path"]
    for name, m in out["evo_kernels"].items():
        extra = {k: m[k] for k in ("library", "db1_adds_ms", "fp32_route") if k in m}
        if name == "evo_bwd_db1":
            extra["kernel"] = "ds_evo_bwd_dkdv (the db1 sum folded into the dk/dv kernel)"
        kernels.append({"name": name, "route": "cuda", "source": EVO_SRC,
                        "replaces": EVO_KERNELS[name], "launches": int(evo_launches[name]),
                        "max_abs_err": m["err"], **{k: m[k] for k in keys}, **extra})
    kernels[-1]["evo_block"] = evo_block
    kernels[0]["v1_path"] = {k: v for k, v in v1.items() if k != "kernels_block128"}
    kernels[0]["tp_path"] = tp
    kernels[0]["hybrid_path"] = hybrid
    kernels[0]["prefix_sample_path"] = prefix
    kernels[0]["families_path"] = families
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
