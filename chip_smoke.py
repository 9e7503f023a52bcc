#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — sparse decode serving of StableLM-1.6B at its
published width and depth (24 layers, d_model 2048, vocab 100352) in bf16
with four slots, then (phase 15) of DeepSeek-MoE-16B, (phases 16-17)
of Yi-9B, Gemma-2B, ChatGLM3-6B and RecurrentGemma-9B and (phases 19-20)
of Mamba2-1.3B and Whisper-tiny, and (phase 24) of Qwen2-VL-72B and
Llama-4-Scout at published width and cut depth — through
``repro_torch.serve.ServeEngine`` (phase 24 also through the serving CLI,
``repro_torch.launch.serve``), with random weights from a seeded
generator, block-magnitude-pruned at (256, 256) (Mamba2's are not: no
plan reaches an SSM site), (phase 21) trains StableLM-1.6B at full
width through ``repro_torch.launch.train`` and (phase 25) through the
sharded train step on a one-rank NCCL group, (phase 26) runs the
expert-parallel MoE body and every other family's sharded step there,
and (phase 27) holds the sharded decode step and the dry-run's traced
predictions against the card:

  1. the card (``torch.cuda``, ``nvidia-smi``);
  2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc),
     and read each library's SASS (``cuobjdump``): the bf16 kernels of
     the flash attention (wgmma), the weight- and input-stationary matmuls
     (mma.sync), and the output-stationary and block-sparse matmuls, bf16
     and bf16 x int8 (one template: mma.sync at M <= 16, wgmma above)
     multiply on the tensor cores (HMMA/HGMMA); every other kernel — the
     float32 instantiations and the summing passes — does not; the bf16
     ``fa_backward`` kernels (``fab_kv_kernel_mma`` / ``fab_q_kernel_mma``,
     hd 64 / 128 / 256) multiply with HGMMA only, load tiles with TMA
     (UTMALDG), hold no atomics and draw no ptxas note (C75xx) that their
     wgmma pipeline is serialised; every kernel's ``ptxas -v`` registers
     and spills are printed under its entry-function name;
  3. bring-up (weights, the weight-sparsity plan, the dense descriptor
     table), then every matmul site the main path runs, on layer 0's pruned
     weight at M = 4: the block-sparse kernel under the plan's blocks and
     metadata, and the flex kernels (all three stationarities) under the
     dense table's schedule, each held against its plain PyTorch version in
     bf16 and float32, with the activation dense (as the path gives it) and
     with half its K-blocks zero; the block-sparse run bitwise against an
     all-live run of the same inputs; the bf16 input-stationary run bitwise
     against the weight-stationary one; and a TF32 control that the float32
     tolerance must reject;
  4. the planned two-sided engine: 8 requests (prompts of 8-16 tokens,
     32 new tokens each, fused blocks of 16), tokens/s, ms per decode step,
     the plan's weight-block skip fraction and each kernel's launches; the
     fused streams must equal the engine's per-token ``step()`` oracle;
  5. on the same weights and prompts, one decode step of: the dense
     descriptor-table engine (flex-matmul kernels), whose logits must equal
     the planned engine's bit for bit — skipping never approximates, and
     the bf16 ``fm_output`` and ``bs_matmul`` share one K order fixed by
     K alone (``flex_matmul.output_grid``); the
     same with every site forced to the weight- and input-stationary
     dataflows, whose logits must equal each other bit for bit (one
     tensor-core tile, the partials added in K-block order by both); and
     the plain engine (float32-accumulated ``torch.matmul``, no kernels) —
     the last three within a stated tolerance;
  6. int8 serving on the same weights (``quantize=True``): every site of
     the int8 path at layer 0 with the quantized plan's blocks and
     metadata — the scaled block-sparse kernel and the int8 matmul kernel
     held against their plain versions in bf16 and float32, dense and
     half-dead activations, under √K·2⁻²⁴·max(|A|@|Q·s|); the scaled
     block-sparse run (rows: the product's own, as the path passes them)
     bitwise against its all-live run and against the int8 matmul kernel;
     the TF32 control rejected; bf16 times beside each bound;
  7. the planned two-sided int8 engine (the first 4 prompts, 16 new tokens,
     fused blocks): tokens/s and ms per decode step, fused streams equal to
     its ``step()`` oracle; one step of the dense int8 descriptor-table
     engine (``int8_matmul`` at every site), whose logits must equal the
     planned int8 engine's bit for bit; every int8 kernel, the split
     grids' sums included, launched; one step of the plain int8 engine
     (weights dequantized to bf16, float32-accumulated ``torch.matmul``)
     within 5% of max |logit|; and, for information, the int8 engine
     against the bf16 one (first-step logits, greedy tokens);
  8. the decode kernels' rows of the ``kernels`` line (below);
  9. long-prompt prefill of the same model (``SHAPES["prefill_32k"]`` cut
     to 2 prompts of 4096 tokens, B·S = 8192): the flash-attention kernel
     against its plain versions at the cell's shape (BH 64, S 4096, hd 64,
     causal), with Sq < Skv, a window and non-causal — in float32 against
     the float64 dense softmax under a derived tolerance that a TF32
     control must fail, in bf16 (scores summed on the tensor cores)
     against the kernel-order plain version under the tensor-core
     tolerance ``ref.flash_tc_check`` (one bf16 ulp of each element, float32
     floors, one bf16 step of every p that the score error could round
     apart; at most twice the share of elements in which a model of the
     tensor cores' summation differs), which p kept in float32, the exact
     softmax rounded to bf16 and p truncated in one warp's rows must
     fail — and layer 0's six matmul
     sites at M = 8192 under the prefill table's schedule (all three
     stationarities, bf16 input-stationary bitwise equal to
     weight-stationary) and the prefill plan's blocks, as in phase 3, with
     per-site times beside the two revisit dataflows' bounds;
 10. bf16 ``model.prefill`` under the dense prefill table (flash kernel in
     every layer: 24 launches), the same table with every site forced
     weight-stationary (the tensor-core ``fm_weight`` at every site; within
     5% of max |logit|), then forced input-stationary (``fm_input`` at every
     site; logits equal to the weight-stationary ones bit for bit), the
     planned two-sided prefill plan (logits
     equal bit for bit), the plain prefill (within 5% of max |logit|);
     ``prefill_with_cache`` (logits equal ``prefill``'s bit for bit, caches
     within 5% of max |cache| of the plain run's), then 16 greedy
     ``decode_many`` steps from its state under the decode table, against
     the same continuation from the plain-prefilled state; one profiled
     prefill on the dense table and one on the plan (device-busy share,
     device time by kernel);
 11. int8 prefill (``quantize=True``): the dense int8 table and the planned
     int8 plan (logits equal bit for bit), the plain int8 prefill (within
     5% of max |logit|); layer 0's six stack sites at M = 8192 as in
     phase 6 (the int8 pair against its plain versions in bf16 and
     float32, dense and half-dead, sparse == all-live == ``int8_matmul``
     bitwise, the TF32 control); the int8 kernels' times at mlp.in;
 12. a ``kernels`` JSON line: per kernel its launches on its main path
     (phases 4-5 for the bf16 matmul kernels, phase 7 for the int8 ones,
     phase 10's dense-table prefill for the flash kernel, which also gives
     its launches over every prefill of phases 10-11), its worst error
     over phases 3 and 9, or 6 and 11, and its time, bound, plain-version
     time and
     library time: the matmul kernels at the mlp.in decode site (for bf16
     x int8 ``torch._weight_int8pack_mm``, which rounds the scales to bf16:
     a yardstick, not the same function, and null where it raises; the
     int8 rows add ``bf16_matmul_ms``, ``torch.matmul`` on the dequantized
     bf16 weight, as a reference point), the flash kernel at the prefill
     cell (library: PyTorch's ``scaled_dot_product_attention``, timed here
     only).  The ``block_sparse``, ``flex_output``, ``flex_weight``,
     ``flex_input``, ``block_sparse_scaled`` and ``int8_matmul`` rows
     also carry the
     launches of their split grids' summing kernels, their device time and
     the library call's (``device_ms``: 20 calls captured in a CUDA graph
     and replayed, since at decode the host, not the card, sets the pace
     of a call; the one device timer of every row), and every
     matmul row its time and
     bound at mlp.in M = 8192 (``prefill_ms``, ``prefill_bound_ms``): the
     bf16 rows from phase 9 beside ``torch.matmul``'s
     (``prefill_library_ms``), the int8 rows from phase 11 beside
     ``torch.matmul`` on the dequantized weight (``prefill_bf16_matmul_ms``;
     their ``prefill_library_ms`` is null: the int8 yardstick is a kernel
     for a few rows);
     ``fm_weight`` and ``fm_input`` add their dataflow bounds at decode
     and prefill and their launches in phase 10's weight- and
     input-stationary prefills; ``fm_input``'s prefill bound is that of
     the kernel's own M-tile (``prefill_dataflow_rows``), and
     ``prefill_dataflow_bound_128rows_ms`` that of 128-row tiles, which
     read B half as often.

 13. the full engine on the same bf16 weights (planned two-sided plan and
     dense table; 6 requests of 8-16 prompt tokens and 12 new tokens, 3
     greedy and 3 sampled at temperature 0.8, top_k 40, seeds 1-3,
     submitted two per tick; 4 slots, prefill chunks of 8, blocks of 4):
     the port's threefry bits and uniforms on the card equal the CPU's bit
     for bit and its Gumbel noise is within an ulp (one ``sample_tokens``
     call at (4, 100352) timed beside an argmax); the async chunked
     engine's streams equal the synchronous whole-prompt engine's, the
     ``step()`` oracle's and the dense table's; a slot poisoned with NaN
     (``serve.faults.poison_slot_state``, dense table) ends its request
     ``failed`` on a clean prefix and leaves the other streams unchanged;
     ``activation_densities`` gives every planned site a density in
     (0, 1], and a replayed decode block makes no synchronizing call,
     counting popcounts or not (``set_sync_debug_mode``);
     ``warmup`` leaves the state bit for bit; ms per decode step async
     against sync and sampled against greedy; and, at 2 layers under a
     ``VirtualClock``, a cancel in mid-decode, a missed deadline and a
     shed request.  ``bs_matmul`` and ``fm_output`` (with their sums)
     must launch; their rows add ``launches_phase13``.

 14. plan tiers and self-speculative decoding on the same weights under a
     weight-only plan, tiers (0.0, 0.5), phase 13's traffic with 16 new
     tokens: the speculative engine (k 4, verify windows of M = 20, run
     as 16 + 4 rows by ``ops.decode_rows``) equals the tiered engine
     without speculation, its ``step()`` oracle and k 3 (M = 16); a
     two-sided engine gates speculation off; a self-drafting engine
     accepts exactly every draft; from a captured state a verify block
     windowed equals sequential and each window position's logits equal
     ``masked_decode_step``'s bit for bit; at layer 0's six sites
     ``bs_matmul`` under the 0.5 tier's lists equals ``fm_output`` on the
     ``prune_k_blocks`` weight bit for bit at M = 4 and 20, and class-1
     requests equal the dense table on the tier-pruned weights end to
     end; int8 speculation equals int8 without; at 2 layers under a
     ``VirtualClock`` a request is demoted and ``warmup`` leaves the state
     bit for bit.  Reported: acceptance, ms per emitted token speculative
     against plain (each twice, in turns), device time of a decode step,
     a draft step and a verify window.  ``bs_matmul``,
     ``bs_matmul_scaled`` and ``fm_output`` (with their sums) must
     launch; their rows add ``launches_phase14``.

 15. the MoE family, with StableLM's weights freed: DeepSeek-MoE-16B at
     its published width, cut to 14 of its 28 layers since PR 28 for the
     wall (the first dense; 64 routed experts top-6 and 2 shared per MoE
     layer; 8.15 B parameters in bf16; every gate reads the first MoE layer
     or the whole stack alike)
     from a seeded generator, every stacked leaf (router and experts
     included) block-magnitude-pruned to 50% at (256, 256); the planned
     two-sided config, the dense table and the int8 plan, each timed, with
     ``max_memory_allocated``.  (a) At the first MoE layer's three expert
     sites, on a dispatch buffer that the real router fills from a random
     hidden state (some experts get no token): the expert-batched
     ``bs_matmul`` (plan's blocks), ``bs_matmul_scaled`` (int8 plan) and
     ``fm_output`` (dense table's schedule) against their plain versions
     under each expert's ``matmul_tol``; (b) each batched launch equal to
     E launches of its 2-D kernel bit for bit, and the dense table equal to
     the plan; (c) the float32 router at every MoE layer: planned == dense
     table bitwise, kernel vs plain within the float32 tolerance, top-k
     set flips with their probability margins; (d) the first MoE layer's
     ``apply_moe`` (kernels) against ``apply_moe_gshard`` routed by the same
     logits, within 2⁻⁶ of max |y|; (e) 4 slots, ``max_seq`` 64, 4 greedy
     requests of 8-16 prompt tokens and 8 new: the planned engine's fused
     streams equal its ``step()`` oracle's, the dense table's first-step
     logits and streams equal the plan's bit for bit, and the planned int8
     engine's fused streams (first 2 requests) equal its oracle's.
     Reported: ms per decode step, one profiled step (device busy share,
     kernels, top device operations, expert-kernel launches: one per site
     and MoE layer, 81, where the reference launches 5184), the step's
     model call timed by the profiler and by ``device_ms`` (the check of
     the profiler's busy time), the share of
     empty expert tile lists, peak memory and the phase's time.  The
     expert-batched kernels must launch; their rows join the ``kernels``
     line, and the 2-D rows add ``launches_phase15``.

 16. the rest of the dense family at published width, one config at a
     time, each freed before the next: ``yi-9b`` (GQA kv 4) cut to 6 of
     its 48 layers, ``gemma-2b`` (its 18 layers, MQA, head dim 256, GeGLU,
     tied and √d-scaled embeddings, vocab 256000) and ``chatglm3-6b``
     (GQA kv 2, RoPE on half the head dims) cut to 4 of its 28 (PR 28,
     for the wall: every gate reads layer 0 or the whole stack alike, so
     depth changes no check), weights from seed 0,
     every stacked matmul weight pruned to 50% at (256, 256), the head
     dense; 4 slots, ``max_seq`` 64, 4 greedy requests of 8-16 prompt
     tokens and 8 new: the planned engine's fused streams equal its
     ``step()`` oracle's, the dense table's first-step logits and streams
     equal the plan's bit for bit, and the plain engine's first-step
     logits lie within 5% of max |logit|.  gemma-2b also runs int8 (the
     planned int8 engine against its oracle, the dense int8 table against
     the plan bit for bit) and first holds the flash kernel at head dim
     256 against its plain versions at its prefill cell (BH 16, S 4096:
     causal, Sq < Skv, window, non-causal; float32 vs the float64 softmax
     with a TF32 control, bf16 under the tensor-core tolerance with its
     three controls), then prefills 2 x 4096 tokens (18 flash launches):
     dense table == plan bit for bit, plain within 5%,
     ``prefill_with_cache`` == ``prefill``;
 17. the Griffin hybrid ``recurrentgemma-9b`` (38 layers: 12 groups of
     two RG-LRU blocks and one attention block of window 2048, then 2
     recurrent layers; MQA, head dim 256) the same way: the flash kernel
     at its prefill cell (BH 32, window 2048) and the other three cases,
     the same decode gates, and a 2 x 4096 prefill through the windowed
     branch (12 flash launches at window 2048): dense table == plan,
     plain within 5%.  The kernels of each config's run must launch; the
     hd-256 flash rows join the ``kernels`` line, and the 2-D matmul rows
     add ``launches_phase16`` / ``launches_phase17``.
 18. FlexNN's analytic core (no new kernel): (a) the paper's Fig 16 —
     ``scheduler.optimize_network`` on the card for resnet101 and yolov2
     under FlexNN (dense) and the Eyeriss-RS and TPU-NLR baselines scaled
     to its SRAM (built as ``benchmarks/bench_energy_vs_fixed.py`` builds
     them), every layer's winning ``Schedule``, energy and cycles equal to
     the same search on the CPU, and the per-network and per-layer %
     reductions of modelled energy (Table I's units, not joules); (b) the
     four profiled networks (§V-C profiles) under two-sided, weight-only
     and no sparsity support, card == CPU on every layer of resnet50 and
     mobilenet_v2 and every 3rd of googlenet and inception_v3; (c) the ZVC
     codec and the CSB on StableLM-1.6B's tensors (rebuilt from seed 0 by
     phase 3's ``bring_up``: phase 4's weights and plan): layer 0's mlp.in
     output for a 128-token row block under ReLU, the SiLU hidden
     activation and the pruned mlp.out weight — decoded == x, packed /
     bitmap / nnz and the ReLU rows' CSB popcounts equal to the CPU's,
     ``zvc_compressed_bytes`` of the mlp.out leaf equal to its
     ``SitePlan.stats`` ZVC bytes; (d) ``ExecConfig(sparse_dispatch=
     False)`` on the planned engine: one decode step runs ``fm_output``
     once at every site and ``bs_matmul`` never, two fused drains (4 x 8
     prompt tokens x 8 new) with the switch off and on give the same
     streams, four ``step()``s' logits are bit-equal under the switch-off
     table, the plan and the dense table, and ``site_plan_estimate`` is
     printed beside each site's measured plan stats.  The CPU's searches
     of (a) and (b) run in 6 worker processes while the card searches.
     An ``analytic`` JSON line holds the phase's seconds, the card's and
     the CPU's search seconds per network, the Fig 16 summary and the
     gate counts; the
     ``block_sparse`` and ``flex_output`` rows add ``launches_phase18``
     (the switch-off drain's).

 19. the SSM family: ``mamba2-1.3b`` at its published width and depth (48
     SSD layers, d 2048, d_inner 4096, 64 SSD heads of 64, d_state 128,
     chunk 256, vocab 50280, tied head; 1.34 B parameters, bf16): (a) the
     tied head's ``fm_output`` against its plain version; (b) layer 0's
     ``ssd_forward`` at 2 x 4096 in bf16 and float32 against the same
     function in float64 on the CPU, under bounds derived from the chunk
     decays' exponent sensitivity (``p19_ssd``; rows the function's own
     float32 gated norm zeroes by overflow are counted, and rows at that
     threshold left out), with a TF32 control; the SSD after the
     in-projection (``ssd_from_proj``, ``p19_ssd_tail``) fed the card's
     projection, against float64 fed the same: float32 under a rounding
     bound that must reject TF32 and a dropped inter-chunk term, bf16 on
     each chunk's last token within 15 bf16 roundings; chunk 1 against the
     stepwise recurrence in float32 (1e-5); (c) 4 slots, ``max_seq`` 64,
     4 greedy requests of 8-16 prompt tokens x 8 new: fused == ``step()``,
     the sparse config's (empty-plan) logits == the dense table's bit for
     bit, ``prefill_chunk`` 4 and 8, async dispatch and a reused slot
     (against a fresh 1-slot engine) give the same streams, the plain
     route within 5% of max |logit|, one profiled step and its model
     call's ``device_ms``; (d) ``model.prefill`` at 2 x 4096 and 1 x 32768
     (the reference's ``long_500k`` cut): ms per prompt token, profiles,
     peak memory, where the chunked form first overflows float32
     (``p19_overflow``), and the prefill cut to the layers before that
     against the plain route (finite logits required, within 5%); (e)
     ``quantize=True`` raises.  The matmul and ``flash_attention`` rows add
     ``launches_phase19`` (every counter read after the phase's run), and
     ``flex_output``, the one kernel the phase compares, adds
     ``max_abs_err_phase19``.
 20. the encoder-decoder: ``whisper-tiny`` at its published width (4 + 4
     layers, d 384, 6 heads, d_ff 1536, vocab 51865, LayerNorm, plain
     GELU), pruned as above: every planned site at layer 0 of the encoder
     and the decoder, cross-attention and the untied head included, as
     in phase 3 (``check_sites``); ``forward_hidden`` and ``prefill`` (the
     encoder pass) on Whisper's window, 2 x 1500 frames and 2 x 448
     tokens: planned == dense table bit for bit, plain within 5%; the
     decode gates (``family_serve``); int8: unplanned raises, planned
     with bf16 weights raises (the residual stream's dtype changes, which
     the reference's scan refuses), planned with float32 weights and
     state serves (the int8 kernels at layer 0's sites, fused ==
     ``step()``).  The matmul and ``flash_attention`` rows add
     ``launches_phase20``; the matmul rows the phase compares add
     ``max_abs_err_phase20``.
 21. training (``run_training``), StableLM-1.6B at full width under the
     train table compiled for ``train_4k`` cut to 4 x 4096 in 2
     microbatches (M = 8192 rows a site), remat ``full``: (a) at every
     site shape the dense route's autograd Function — dX = dY·Wᵀ and dW =
     Xᵀ·dY through ``fm_output`` — against autograd of the plain product,
     float32 within ``matmul_tol`` (TF32 control rejected), bf16 within
     it plus one bf16 rounding; (b) ``fa_backward`` at BH 64, S 4096, hd 64
     and 128, causal, window 1024 and Sq < Skv: float32 against the float64
     plain backward (tolerance 4x the float32 plain version's own error;
     TF32 control rejected), bf16 against ``flash_attention_backward_plain``
     under ``ref.flash_backward_check`` (truncated P and dS rejected), two
     runs bit-equal, the forward's O with lse equal to O without; (c) at
     depth 2 one AdamW step under the kernels (the table, then every site
     forced weight- and input-stationary) against the plain step, float32
     and bf16, loss, every gradient and the updated parameters, and remat
     ``none`` == ``full`` bit for bit; (d) at depth 2, 2 steps + a
     checkpoint under ``build/``, a fresh ``Trainer`` resumed to step 4 and
     a straight 4-step run, bit-equal (files deleted); (e) the published 24
     layers through ``launch.train.make_trainer`` (lr 1e-4, warmup 1): 4
     steps on one fixed batch (the loss must fall by 0.05 nats), one
     profiled, then 2 from the
     ``TokenPipeline``: ms a step, tokens/s, peak memory, busy share, top
     kernels; ``fm_output``, ``flash_attention`` and ``flash_backward`` must
     have launched.  The ``kernels`` line gains ``flash_backward`` and the
     backward products at mlp.in (``flex_output_backward_dx`` / ``_dw``),
     and every matmul and flash row ``launches_phase21``.
 22. the other families train (``run_families_training``): (a)
     ``fa_backward`` at hd 256 at gemma-2b's cell (BH 16, S 4096, causal),
     recurrentgemma-9b's (BH 32, S 4096, window 2048) and Sq < Skv, with
     phase 21's gates (float32 against float64 with the TF32 control,
     bf16 under ``ref.flash_backward_check`` with the truncation control,
     two runs bit-equal); (b) the expert route's backward at
     DeepSeek-MoE-16B's layer-1 experts_in / experts_gate / experts_out
     shapes at C = 961 (one 2 x 4096 microbatch's capacity): dX and dW
     against autograd of the plain batched product per expert, float32
     (TF32 control rejected) and bf16, and at C = 2 the batched dX launch
     (Wᵀ read in place) equal to per-expert launches bit for bit; (c) at
     full width and cut depth — deepseek-moe-16b at 2 layers, gemma-2b at
     2, recurrentgemma-9b at 3 (one Griffin group), whisper-tiny uncut
     (2 x 448 tokens, 2 x 1500 frames), mamba2-1.3b at 1 — one AdamW step
     under the kernels against the plain step with phase 21's tolerances,
     float32 and bf16, and for the MoE remat none == full bit for bit
     (mamba2-1.3b's gradients that are non-finite on the plain side, the
     reference's SSD overflow, are counted and left out; the kernel step
     must be finite wherever the plain one is); (d) gemma-2b at its 18
     layers, deepseek-moe-16b cut to 4 and recurrentgemma-9b cut to 6, at
     full width through ``launch.train.make_trainer`` (4 x 4096 tokens a
     step in 2 microbatches, remat full, lr 1e-4): 4 steps on one fixed
     batch (the loss must fall by 0.05 nats), one profiled: ms a step,
     tokens/s, peak memory, busy share, launches.  The ``kernels`` line
     gains ``flash_backward_hd256`` / ``_hd256_window`` and
     ``flex_output_experts_backward_dx`` / ``_dw``, and the
     ``flex_output`` and ``flash_attention`` rows ``launches_phase22``.

 23. the serve executables (``serve/executables.py``: every model call of
     the engine a replayed CUDA graph), run after phase 8 on StableLM-1.6B
     (bf16 and int8 planned, 4 slots, blocks of 16) and inside phase 15
     on DeepSeek-MoE-16B (bf16 planned): ``warmup`` captures every shape
     and leaves the state bit for bit (seconds, graphs, pool bytes); from
     4 live rows a replayed block of 16 equals ``model.decode_many`` on a
     copy of the state (tokens, carries, every state leaf bit for bit)
     and credits the kernels' ``LAUNCHES`` as the eager call counts them;
     ms per decode step and tokens/s eager against replayed (each twice,
     in turns); the busy share of a profiled replay; 0 synchronizing
     calls per replayed block; a 21-token feed replayed as 16 + 8
     positions equals one unpadded eager feed; ms per prompt token of
     admitting 16, 64 and 512 tokens; phase 4's first wave on the eager
     entry points (``eager_entries``, 8 tokens) gives phase 4's streams;
     a planted ``.item()`` raises ``CaptureError`` at capture, and the
     allocator releases memory after it.  Phase 13 adds run A's first 4
     requests on the eager entry points (streams equal) and 0
     synchronizing calls per replayed block, stats on and off; phase 14
     the replayed greedy verify block against ``model.verify_block``
     (state, tokens, launches) and the speculative engine's first 4
     requests x 8 on the eager entry points.  An ``executables`` JSON
     line holds the figures.  Phase 22's full-width runs allocate in
     expandable segments (``expandable_segments``).
 24. after phase 22, the earlier weights freed: the flash kernel at hd
     128 at the prefill cell (16 of Qwen2-VL's 128 (batch, head) rows, S
     4096, causal) under phase 9's gates; (a) the serving CLI as a user
     starts it, ``launch.serve.main`` at StableLM-1.6B's published config
     (4 requests x 8 new tokens, bf16, the dense table): every request
     served, ``fm_output`` launched; then Qwen2-VL-72B (M-RoPE, GQA 64 /
     8, d_ff 29568: ragged at 256-blocks) at 20 of its 80 layers and
     Llama-4-Scout (top-1 over 16 experts plus a shared one, vocab 202048)
     at 12 of its 48, at published width (``P24_LAYERS``): phase 3's site
     checks at layer 0 (the ragged edge tiles included; Llama-4's expert
     sites and router as phase 15 holds them, its oracle step profiled
     with the expert-batched launches counted, and top-1 flips between
     the kernel and the plain router counted), the planned engine (4
     slots, 4 requests x 8 new) == its ``step()`` oracle (then the same
     requests on the warm engine: tokens/s and ms per replayed decode
     step), one step of the dense table == the plan bit for bit, the
     plain engine within 5% (Llama-4's routed as the planned engine, its
     flips counted, as phase 22's plain step);
     then a 2 x 4096 prefill with the vision prefix (1024 rows of patch
     embeddings, a 32 x 32 grid's distinct t / h / w streams) through
     the flash kernel: dense table (twice, bit for bit), plan (bit for
     bit), plain (5%; Llama-4's routed as the table's run), and a
     control with t = h = w that must move Qwen2-VL's logits and must not
     move Llama-4's.  Per config: depth, peak memory, tokens/s, ms per
     decode step, prefill seconds and wall (a ``last_configs`` JSON
     line); the ``kernels`` line gains ``flash_attention_hd128`` and
     ``launches_phase24`` / ``max_abs_err_phase24`` on the rows phase 24
     launches or compares.
 25. distribution (``run_distribution``), after phase 22 with the earlier
     weights freed, on a process group of one NCCL rank (a ``file://``
     init under ``build/``; the card's one H100 cannot hold two ranks, so
     the multi-rank arithmetic is held on the CPU): an all-reduce of 64
     MiB leaves its tensor as it was (timed); (a) StableLM-1.6B at its 24
     layers on phase 21's cell (4 x 4096 in 2 microbatches, remat full,
     bf16, the train table): 3 steps of ``build_train_step(mesh, rules)``
     on ``make_host_mesh(model=1)`` equal 3 unsharded kernel steps from
     the same weights bit for bit — loss, grad norm, every parameter and
     moment (the unsharded result held on the host) — and one step with
     one embedding row moved must move the loss; ms a step, tokens/s,
     peak memory, device busy time and the NCCL kernels' time of a
     profiled step; ``fm_output``, ``flash_attention`` and
     ``flash_backward`` must have launched; (b)
     ``build_dp_compressed_step`` in ``int8`` and ``zvc_topk`` at 2
     layers, full width, 2 x 2048: the update bit-equal to the
     in-process composition (quantize -> dequantize -> the mean of one,
     or the top-k mask, -> AdamW), the error feedback nonzero and equal
     to what was dropped; (c) ``pipeline_apply`` with one stage on CUDA
     tensors equal to the sequential loop; (d) ``python -m
     repro_torch.launch.train`` in a subprocess under torchrun's
     environment of a world of one (the launcher opens the NCCL group),
     3 steps of the published 24 layers.  The matmul and flash rows of
     the ``kernels`` line gain ``launches_phase25``; a ``distribution``
     JSON line holds the figures.
 26. expert parallelism and every family's sharded step
     (``run_expert_parallel``), after phase 25 on a new one-rank NCCL
     group: (a) ``moe._apply_moe_ep`` at ep = 1 on one full-width MoE
     layer of DeepSeek-MoE-16B (E 64, top-6) and Llama-4-Scout (E 16,
     top-1), 2 x 4096 tokens, bf16, the train table, forward and the
     gradients of x and every routed leaf: against ``_apply_moe_local``
     the expert leaves bit for bit, the output bit for bit at top-1 and
     within the combine's bf16 bound at top-6, router and x within 2⁻⁶;
     against the plain route (routed as the kernels) within 2⁻⁵; the
     expert kernels must launch at least once per expert and site; (b)
     experts_in's forward, dX and dW at a 4-way expert-parallel rank's
     shapes ((16, 961, 2048) @ (16, 2048, 1408) and (4, 641, 5120) @
     (4, 5120, 8192)) against the plain batched product, each timed
     beside its bound, the plain version and ``torch.bmm`` (six rows of
     the ``kernels`` line); (c) the one-rank sharded step of
     deepseek-moe-16b (2 layers), recurrentgemma-9b (3), mamba2-1.3b (1)
     and whisper-tiny (4) — and the gradients of llama4-scout and
     qwen2-vl-72b (1 layer each, vision prefix), whose AdamW state does
     not fit beside them — bit-equal to the unsharded kernel step at
     full width, 2 x 4096 tokens in 2 microbatches (whisper 2 x 448 over
     1500 frames), every loss, grad norm, parameter, moment and gradient
     finite on both sides; ms a step (the median of 3 warm calls a side,
     alternating) and peak GiB; ``fm_output``, ``flash_attention`` and
     ``flash_backward`` must have launched.  The matmul and flash rows
     gain ``launches_phase26``; an ``expert_parallel`` JSON line holds
     the figures.
 27. the dry-run and roofline tooling (``run_tooling``), last, on a new
     one-rank NCCL group, while (c) runs in three processes of its own:
     (a) the sharded decode step (``serve.engine.build_serve_step`` under
     decode rules on the one-rank mesh, the caches' rows cut over
     ``model`` or not) of StableLM-1.6B at 4 layers, DeepSeek-MoE-16B
     and Mamba2-1.3B at 2, RecurrentGemma-9B at 3 (its rolling window
     wraps) and Whisper-tiny at 2, full width, bf16, the decode table,
     8 steps of 4 rows at their own positions in a 32768-row cache filled
     from a seed: logits at every step and the whole state bit-equal to
     ``model.decode_step``, kernels launched; (b) StableLM-1.6B's train
     (phase 21's cell), prefill (1 x 32768) and decode (decode_32k at
     batch 4) cells on the one-card mesh: ``trace_cell`` on fake CUDA
     tensors predicts peak, FLOPs and the H100 roofline bound, then the
     step runs for real — the traced FLOPs must equal the real step's
     (``FlopCounterMode`` plus the kernel wrappers' counters) and the
     predicted peak / ``max_memory_allocated`` (after a reset, inputs
     resident, less what was held before them) must lie in [0.85, 1.15];
     the median of 3 warm calls against the bound is reported; (c)
     ``python -m repro_torch.launch.dryrun`` for stablelm-1.6b@train_4k
     (single) and deepseek-moe-16b@decode_32k (multi) and ``python -m
     repro_torch.roofline.analysis`` for stablelm-1.6b@train_4k exit 0
     (records under ``build/p27/``): GiB a rank, FLOPs, collective GiB,
     dominant term, wall.  A ``tooling`` JSON line holds the figures.

Exits non-zero on any failure, without a CUDA device, or outside a checkout
of the repository.  The last line is the device JSON; the whole report
is also written to ``build/chip_smoke.log`` in the checkout.

    python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BPS = 3.35e12          # H100 SXM device-memory bandwidth (data sheet)
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
N_SLOTS = 4
TINY32 = 1.1754943508222875e-38   # float32's smallest normal
# the bf16 decode kernels; ``*_sum`` add a split grid's partials in K order
# (a second kernel of the same call)
SLICE1_KERNELS = ("block_sparse", "block_sparse_sum", "output", "output_sum",
                  "weight", "weight_sum", "input", "input_sum")
# the bf16 tensor-core kernels each library must hold (phase 2)
TENSOR_CORE_KERNELS = {"flash_attention": ("fa_kernel_mma",
                                           "fab_kv_kernel_mma",
                                           "fab_q_kernel_mma"),
                       "flex_matmul": ("ws_kernel_mma", "is_kernel_mma",
                                       "os_kernel_mma", "os_wg_kernel_mma"),
                       "block_sparse": ("bs_kernel_mma", "bs_wg_kernel_mma",
                                        "bsq_kernel_mma",
                                        "bsq_wg_kernel_mma"),
                       "int8_matmul": ("i8_kernel_mma", "i8_wg_kernel_mma")}
# kernel-name fragments of the port's CUDA kernels, by the entry point that
# launches them (first match wins), for the profiles' breakdowns
KERNEL_FAMILIES = (("bs_kernel_mma", "bs_matmul"),
                   ("bs_wg_kernel_mma", "bs_matmul"),
                   ("bsq_kernel_mma", "bs_matmul_scaled"),
                   ("bsq_wg_kernel_mma", "bs_matmul_scaled"),
                   ("i8_kernel_mma", "i8_matmul"),
                   ("i8_wg_kernel_mma", "i8_matmul"),
                   ("os_kernel_mma", "fm_output"),
                   ("os_wg_kernel_mma", "fm_output"),
                   ("seg_sum_kernel", "segment sums"),
                   ("ws_kernel", "fm_weight"), ("is_kernel", "fm_input"),
                   ("tile_kernel", "tile.cuh (float32)"),
                   ("fab_", "flash backward"), ("fa_kernel", "flash"))
# the int8 kernels; ``*_sum`` add (and scale) a split grid's partials
INT8_KERNELS = ("block_sparse_scaled", "block_sparse_scaled_sum",
                "int8_matmul", "int8_matmul_sum")
PREFILL_SITES = ("attn.q", "attn.kv", "attn.out", "mlp.in", "mlp.gate",
                 "mlp.out")
SEED = 0


class SmokeFailure(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call of ``fn`` (CUDA events, warmed)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 20, replays: int = 3):
    """Mean device milliseconds per call of ``fn``: ``calls`` calls captured
    in one CUDA graph (warmed), CUDA events around ``replays`` replays.
    The graph keeps the host out of the way, so this is the card's own time
    for the calls' kernels run back to back, where ``cuda_ms`` includes the
    host's gaps when the host is the slower side.  The one device timer of
    every kernel row and of phase 15's decode step (``torch.profiler`` read
    less than the bound for single expert kernels after the earlier
    phases' profiles).  None (not measured; the reason on stderr) when
    ``fn`` cannot be captured because it synchronizes with the host."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
    except RuntimeError as err:
        torch.cuda.synchronize()
        print(f"device_ms: not measured ({type(err).__name__}: "
              f"{str(err)[:160]})", file=sys.stderr)
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def bound_ms(n_bytes: float, flops: float):
    t_b, t_f = n_bytes / HBM_BPS, flops / BF16_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def bs_bound_ms(a, meta, blocks, w_elem=None, scale_elem=0):
    """Block-sparse bound over the blocks this run's data needs: each A
    block and each weight block that some live pair takes, once (``w_elem``
    bytes per weight element, default A's), the column scales
    (``scale_elem`` bytes each) of the column tiles with a live pair, once,
    and the float32 output once; the MACs of the live block pairs.
    Metadata with a leading expert axis counts every expert's: an expert
    that got no token has no live pair, so its A blocks, weight blocks and
    scales count nothing."""
    bm, bk, bn = blocks
    # (..., tm, tn, tk): A block (i, k) meets weight block (k, j)
    csb = (meta.a_bitmap[..., :, None, :]
           & meta.b_bitmap.transpose(-1, -2)[..., None, :, :])
    live_a = int(csb.any(-2).sum())
    live_b = int(csb.any(-3).sum())
    live_cols = int(csb.any(-1).any(-2).sum())
    elem = a.element_size()
    n_bytes = (live_a * bm * bk * elem + live_b * bk * bn * (w_elem or elem)
               + live_cols * bn * scale_elem
               + (a.numel() // a.shape[-1]) * meta.b_bitmap.shape[-1] * bn * 4)
    return bound_ms(n_bytes, 2.0 * int(meta.kcnt.sum()) * bm * bk * bn)


def ws_dataflow_ms(m: int, n: int, k: int, bk: int, elem: int = 2):
    """Least time of the weight-stationary dataflow's own traffic: B once,
    A once per 128-wide N-strip, and the float32 output read-modify-written
    once per K-block — (2·tk − 1)·M·N·4 bytes — over the card's memory
    rate."""
    tk, strips = k // bk, -(-n // 128)
    n_bytes = k * n * elem + strips * m * k * elem + (2 * tk - 1) * m * n * 4
    return n_bytes / HBM_BPS * 1e3


def is_dataflow_ms(m: int, n: int, k: int, bk: int, rows: int,
                   elem: int = 2):
    """Least time of the input-stationary dataflow's own traffic: A once, B
    once per M-tile of ``rows``, and the float32 output read-modify-written
    once per K-block — (2·tk − 1)·M·N·4 bytes — over the card's memory
    rate."""
    tk, mtiles = k // bk, -(-m // rows)
    n_bytes = m * k * elem + mtiles * k * n * elem + (2 * tk - 1) * m * n * 4
    return n_bytes / HBM_BPS * 1e3


def matmul_tol(a, b) -> float:
    """Float32 tolerance for K products: √K·2⁻²⁴·max(|A|@|B|).  Two float32
    sums of the same products in different orders differ by roundings of
    random sign, which grow like √K; operands cut to TF32's 10-bit mantissa
    err by ~2⁻¹⁰ per product and land far outside it (phase 3's control)."""
    import torch
    k = a.shape[1]
    mag = torch.matmul(a.abs().float(), b.abs().float()).max().item()
    return k ** 0.5 * 2.0 ** -24 * mag


def tf32(x):
    """float32 ``x`` with its mantissa cut to TF32's 10 bits: the operand a
    TF32 tensor-core product would see."""
    import torch
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def all_live(meta):
    """``meta`` with every K-block listed for every tile (nothing skipped)."""
    import torch
    tk = meta.a_bitmap.shape[1]
    return dataclasses.replace(
        meta, max_nnz=tk,
        kidx=torch.arange(tk, dtype=torch.int32, device=meta.kcnt.device)
        .expand(meta.kcnt.shape + (tk,)).contiguous(),
        kcnt=torch.full_like(meta.kcnt, tk))


def _launch_dicts():
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels import int8_matmul as i8
    return (bs.LAUNCHES, fm.LAUNCHES, i8.LAUNCHES, fa.LAUNCHES)


def reset_launches(counts=None) -> None:
    """Set every wrapper's launch count to 0, or back to ``counts``."""
    for d in _launch_dicts():
        for key in d:
            d[key] = 0 if counts is None else counts[key]


def launch_counts() -> dict:
    out = {}
    for d in _launch_dicts():
        out.update(d)
    return out


def forced(ec, stat):
    """The descriptor-table ExecConfig ``ec`` with every site's schedule
    forced to the stationarity ``stat`` (its blocks kept)."""
    sites = {s: dataclasses.replace(d, schedule=dataclasses.replace(
        d.schedule, stationarity=stat))
        for s, d in ec.schedules.sites.items()}
    return dataclasses.replace(ec, schedules=dataclasses.replace(
        ec.schedules, sites=sites))


def check_tensor_cores(build, report) -> None:
    """Phase 2b: the SASS of every built library.  The bf16 tensor-core
    kernels (``*kernel_mma``, each of ``TENSOR_CORE_KERNELS`` present) must
    multiply with HMMA/HGMMA; every other kernel — the float32
    instantiations, ``tile.cuh``'s kernels and the summing passes — must
    have none (true float32 FMAs, no TF32)."""
    for name in build.SOURCES:
        counts = build.tensor_core_ops(name)
        need(bool(counts), f"{name}: cuobjdump listed no kernel")
        mma = {f: c for f, c in counts.items() if "kernel_mma" in f}
        other = {f: c for f, c in counts.items() if "kernel_mma" not in f}
        need(all(c > 0 for c in mma.values()),
             f"{name}: a tensor-core kernel has no HMMA/HGMMA: {mma}")
        need(not any(other.values()), f"{name}: tensor-core instructions "
             f"outside the bf16 redesign: {other}")
        report(f"  [{name}] SASS tensor-core instructions: "
               f"{sum(mma.values())} in {len(mma)} bf16 tensor-core kernels"
               f", 0 in the other {len(other)}")
        for kernel in TENSOR_CORE_KERNELS.get(name, ()):
            hits = {f: c for f, c in mma.items() if kernel in f}
            need(bool(hits), f"{name}: no {kernel} in the SASS")
            report(f"    {kernel}: {sum(hits.values())} HMMA/HGMMA in "
                   f"{len(hits)} instances")
    # the flash kernel's head-dim-256 instance (q read by wgmma from
    # shared memory) is on the tensor cores too
    hd256 = {f: c for f, c in build.tensor_core_ops("flash_attention").items()
             if "fa_kernel_mma" in f and "ILi256E" in f}
    need(bool(hd256) and all(c > 0 for c in hd256.values()),
         f"flash_attention: no HGMMA in the hd-256 instance: {hd256}")
    report(f"    fa_kernel_mma<256>: {sum(hd256.values())} HGMMA")


def check_backward_kernels(build, report) -> None:
    """Phase 2c: the six bf16 ``fa_backward`` kernels (``fab_kv_kernel_mma``,
    ``fab_q_kernel_mma``, hd 64 / 128 / 256) hold their design, as
    ``build.backward_kernel_faults`` reads it from the SASS and this build's
    ptxas log: wgmma alone, TMA loads, no atomics, no serialised wgmma
    pipeline.  Their ``ptxas -v`` lines are phase 2's."""
    ops = build.sass_ops("flash_attention")
    log = build.BUILD_LOG.get("flash_attention", "")
    faults = build.backward_kernel_faults(ops, log)
    notes = "no C75xx note" if log else "ptxas log not of this run"
    need(len(faults) == 6, f"flash_attention: expected 6 bf16 fa_backward "
         f"kernels in the SASS, found {sorted(faults)}")
    for fn in sorted(faults):
        need(not faults[fn], f"{fn}: {faults[fn]}")
        c = ops[fn]
        report(f"  [flash_attention] {fn}: SASS HGMMA {c.get('HGMMA', 0)}, "
               f"HMMA 0, UTMALDG {c.get('UTMALDG', 0)}, UBLKCP "
               f"{c.get('UBLKCP', 0)}, atomics 0, {notes}")


# ---------------------------------------------------------------------------
# bring-up
# ---------------------------------------------------------------------------

def bring_up(report):
    import torch
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.core.sparsity import map_leaves, prune_stacked_magnitude
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import decode_exec_config

    cfg = get_config("stablelm-1.6b")
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device="cuda")
    params = map_leaves(
        lambda _, leaf: prune_stacked_magnitude(leaf, 0.5, (256, 256)),
        params)
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    planned = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                 device="cuda")
    dense = decode_exec_config(cfg, N_SLOTS, use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    report(f"params + plan bring-up ({cfg.n_layers} layers): "
           f"{time.perf_counter() - t0:.1f} s; weight-block skip fraction "
           f"{planned.plan.block_skip_fraction():.4f}")
    report(planned.schedules.describe())
    report(dense.schedules.describe())
    return cfg, sp_cfg, params, planned, dense


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain versions at every site of the main path
# ---------------------------------------------------------------------------

def check_sites(params, planned, dense, report) -> dict:
    """Every planned weight leaf (one per site) at layer 0, the shapes and
    blocks the main path launches (a MoE stack's expert leaves and its
    float32 router are ``p15_kernels``' and ``p15_router``'s).  Returns
    the worst error per kernel and the bf16 mlp.in operands, if the stack
    has that site, for the ``kernels`` line."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import block_sparse_matmul_ref, matmul_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    attached = planned.plan.attach(params)
    stats = ("output", "weight", "input")
    worst = dict.fromkeys(("block_sparse",) + stats, 0.0)
    keep = {}
    for e in planned.plan.entries.values():
        if len(e.lead) > 1 or e.site == "moe.router":
            continue            # p15_kernels and p15_router hold these
        pw = attached
        for key in e.path:
            pw = pw[key]
        if e.lead:
            pw = pw.index(0)
        desc = dense.schedules.sites[e.site]
        sched = desc.schedule
        k, n = pw.w_kn.shape
        a_full = torch.randn((desc.m, k), generator=gen, device=dev)
        kb = torch.rand(-(-k // e.bk), generator=gen, device=dev) < 0.5
        a_half = a_full * kb.repeat_interleave(e.bk)[:k]
        for dtype in (torch.bfloat16, torch.float32):
            # a ragged site keeps its weight zero-padded (``wpad``) too
            pwd = dataclasses.replace(pw, w=pw.w.to(dtype), wpad=None
                                      if pw.wpad is None else
                                      pw.wpad.to(dtype))
            w_kn = pwd.w_kn                  # transposed view for the head
            errs = dict.fromkeys(worst, 0.0)
            tol = 0.0
            for act, a32 in (("dense", a_full), ("half", a_half)):
                a = a32.to(dtype)
                tol_a = matmul_tol(a, w_kn)
                tol = max(tol, tol_a)
                xp, wp, meta, _ = planned_operands(a, pwd)
                out = bs.block_sparse_matmul(xp, wp, meta,
                                             out_dtype=torch.float32)
                err = (out - block_sparse_matmul_ref(xp, wp, meta)) \
                    .abs().max().item()
                same = torch.equal(out, bs.block_sparse_matmul(
                    xp, wp, all_live(meta), out_dtype=torch.float32))
                need(err <= tol_a, f"block_sparse {e.site} {dtype} {act}: "
                     f"error {err} > {tol_a}")
                need(same, f"block_sparse {e.site} {dtype} {act}: sparse "
                     f"!= all-live run")
                errs["block_sparse"] = max(errs["block_sparse"], err)
                plain = matmul_ref(a, w_kn)
                outs = {}
                for stat in stats:
                    s = dataclasses.replace(sched, stationarity=stat)
                    outs[stat] = fm.flex_matmul(a, w_kn, schedule=s,
                                                out_dtype=torch.float32)
                    err = (outs[stat] - plain).abs().max().item()
                    need(err <= tol_a, f"flex_{stat} {e.site} {dtype} {act}"
                         f": error {err} > {tol_a}")
                    errs[stat] = max(errs[stat], err)
                need(dtype is torch.float32 or torch.equal(
                    outs["input"], outs["weight"]),
                    f"flex_input {e.site} {dtype} {act}: differs from "
                    f"flex_weight")
                if dtype is torch.bfloat16 and act == "dense" \
                        and e.site == "mlp.in":
                    keep.update(a=a, w=w_kn, meta=meta, sched=sched,
                                blocks=(e.bm, e.bk, e.bn))
            line = (f"{e.site} {str(dtype)[6:]} M={desc.m} K={k} N={n}"
                    f"{' (B read transposed)' if e.transpose else ''}: "
                    f"block_sparse ({e.bm},{e.bk},{e.bn}) "
                    f"{errs['block_sparse']:.3e}, flex ({sched.bm},"
                    f"{sched.bn},{sched.bk}) output/weight/input "
                    f"{errs['output']:.3e}/{errs['weight']:.3e}/"
                    f"{errs['input']:.3e}; tol {tol:.3e}; sparse == "
                    f"all-live bitwise")
            if dtype is torch.bfloat16:
                line += "; input == weight bitwise"
            if dtype is torch.float32:
                a = a_full
                plain = matmul_ref(a, w_kn)
                ctrl = (matmul_ref(tf32(a), tf32(w_kn)) - plain) \
                    .abs().max().item()
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    lib = (torch.matmul(a, w_kn) - plain).abs().max().item()
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                line += (f"; TF32 control {ctrl:.3e} (must exceed tol), "
                         f"torch.matmul with allow_tf32 {lib:.3e}")
                need(ctrl > matmul_tol(a, w_kn),
                     f"{e.site}: the float32 tolerance does not reject "
                     f"TF32 operands ({ctrl})")
            report(line)
            for key in worst:
                worst[key] = max(worst[key], errs[key])
        # bf16 times at this site, activation dense as on the path
        a, w_kn = a_full.to(torch.bfloat16), pw.w_kn
        xp, wp, meta, _ = planned_operands(a, pw)
        b_ms, _ = bs_bound_ms(xp, meta, (e.bm, e.bk, e.bn))
        t_bs = cuda_ms(lambda: bs.block_sparse_matmul(
            xp, wp, meta, out_dtype=torch.float32))
        t_fm = cuda_ms(lambda: fm.flex_matmul(
            a, w_kn, schedule=sched, out_dtype=torch.float32))
        t_plain = cuda_ms(lambda: matmul_ref(a, w_kn))
        t_lib = cuda_ms(lambda: torch.matmul(a, w_kn))
        report(f"  {e.site} bf16 ms: block_sparse {t_bs:.4f} (bound "
               f"{b_ms:.5f}), flex_{sched.stationarity} {t_fm:.4f}, plain "
               f"{t_plain:.4f}, torch.matmul {t_lib:.4f}")
    need(bool(keep) or "mlp.in" not in dense.schedules.sites,
         "no mlp.in site in the plan")
    torch.cuda.synchronize()
    keep["errs"] = worst
    return keep


def time_kernels(t, launches) -> list:
    """The ``kernels`` line: bf16 x @ w_in at decode shape (M=4, K=2048,
    N=5632), the weight block-pruned at (256, 256), the activation dense."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import block_sparse_matmul_ref, matmul_ref

    a, w, meta, sched = t["a"], t["w"], t["meta"], t["sched"]
    m, k = a.shape
    n = w.shape[1]
    saved = launch_counts()
    lib_ms = cuda_ms(lambda: torch.matmul(a, w))
    lib_device_ms = device_ms(lambda: torch.matmul(a, w))
    rows = []
    b_ms, b_by = bs_bound_ms(a, meta, t["blocks"])

    def bs_call():
        return bs.block_sparse_matmul(a, w, meta, out_dtype=torch.float32)

    rows.append({
        "name": "block_sparse", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_sparse.cu",
        "replaces": "src/repro/kernels/block_sparse.py:49",
        "launches": launches["block_sparse"],
        "launches_sum": launches["block_sparse_sum"],
        "max_abs_err": t["errs"]["block_sparse"],
        "ms": cuda_ms(bs_call),
        "plain_ms": cuda_ms(lambda: block_sparse_matmul_ref(a, w, meta)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "device_ms": device_ms(bs_call),
        "library_device_ms": lib_device_ms})
    b_ms, b_by = bound_ms(a.numel() * 2 + w.numel() * 2 + m * n * 4,
                          2.0 * m * n * k)
    replaces = {"output": "src/repro/kernels/flex_matmul.py:52",
                "weight": "src/repro/kernels/flex_matmul.py:68",
                "input": "src/repro/kernels/flex_matmul.py:68"}
    plain_ms = cuda_ms(lambda: matmul_ref(a, w))
    for stat in ("output", "weight", "input"):
        s = dataclasses.replace(sched, stationarity=stat)
        rows.append({
            "name": f"flex_{stat}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flex_matmul.cu",
            "replaces": replaces[stat],
            "launches": launches[stat],
            "max_abs_err": t["errs"][stat],
            "ms": cuda_ms(lambda: fm.flex_matmul(
                a, w, schedule=s, out_dtype=torch.float32)),
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    for row, stat in zip(rows[1:4], ("output", "weight", "input")):
        s = dataclasses.replace(sched, stationarity=stat)
        row.update(launches_sum=launches[f"{stat}_sum"],
                   device_ms=device_ms(lambda: fm.flex_matmul(
                       a, w, schedule=s, out_dtype=torch.float32)),
                   library_device_ms=lib_device_ms)
    rows[2]["dataflow_bound_ms"] = ws_dataflow_ms(m, n, k, sched.bk)
    rows[3]["dataflow_bound_ms"] = is_dataflow_ms(m, n, k, sched.bk,
                                                  fm.revisit_rows(m))
    reset_launches(saved)
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the serving engine at full width
# ---------------------------------------------------------------------------

# host-side profiler records that ``prof.events()`` leaves out
PROFILER_SKIPPED = ("[memory]", "[OutOfMemory]",
                    "profiler::_record_function_enter",
                    "profiler::_record_function_enter_new",
                    "profiler::_record_function_exit", "aten::is_leaf",
                    "aten::output_nr", "aten::_version")


def device_events(prof) -> list:
    """(name, µs) of each device event of a ``torch.profiler`` run: the
    CUDA events ``prof.events()`` lists, with their
    ``device_time_total`` (an async one counts 0), read from the raw
    kineto results.  ``prof.events()`` first builds an event for every
    host op as well, which took ~18 s for 300k host events and set much
    of the wall of each phase that reports a profile (PR 28)."""
    import torch
    cached = getattr(prof, "_device_events", None)
    if cached is not None:
        return cached
    out = []
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != torch.autograd.DeviceType.CUDA
                or ev.name() in PROFILER_SKIPPED
                or getattr(ev, "is_hidden_event", lambda: False)()):
            continue
        idle = ev.is_async() or ev.start_thread_id() != ev.end_thread_id()
        out.append((torch._C._demangle(ev.name()),
                    0.0 if idle else (ev.end_ns() - ev.start_ns()) / 1e3))
    prof._device_events = out
    return out


def device_tops(prof, n) -> list:
    """The ``n`` device event names of most summed time: (name, (µs,
    count)), as ``prof.key_averages()`` groups them."""
    tops = {}
    for name, us in device_events(prof):
        t, c = tops.get(name, (0.0, 0))
        tops[name] = (t + us, c + 1)
    return sorted(tops.items(), key=lambda kv: -kv[1][0])[:n]


def _families(pairs):
    """(busy µs, events, {family: (µs, events)}) of (name, µs) pairs, the
    port's kernels by ``KERNEL_FAMILIES`` and everything else as
    "other"."""
    busy, n_kernels, fam = 0.0, 0, {}
    for name, t in pairs:
        busy += t
        n_kernels += 1
        key = next((f for frag, f in KERNEL_FAMILIES if frag in name),
                   "other")
        us, n = fam.get(key, (0.0, 0))
        fam[key] = (us + t, n + 1)
    return busy, n_kernels, fam


def device_breakdown(prof):
    """(device-busy µs, kernel launches, {family: (ms, launches)}) of a
    ``torch.profiler`` run."""
    busy, n_kernels, fam = _families(device_events(prof))
    return busy, n_kernels, {k: (round(us / 1e3, 3), n)
                             for k, (us, n) in fam.items()}


def check_device_events(prof, report) -> None:
    """``device_events`` against the profiler's own readings of the same
    run: the busy time, event count and families through
    ``prof.events()`` and the per-name sums and counts of
    ``prof.key_averages()`` must equal ``device_breakdown``'s and
    ``device_tops``' (to float rounding of the µs)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA

    def close(a, b):
        return abs(a - b) <= 1e-6 * max(abs(a), abs(b)) + 1e-3

    busy, n_kernels, fam = _families(device_events(prof))
    busy_e, n_e, fam_e = _families((ev.name, ev.device_time_total)
                                   for ev in prof.events()
                                   if ev.device_type == cuda)
    need(n_kernels == n_e and close(busy, busy_e)
         and fam.keys() == fam_e.keys()
         and all(fam[k][1] == fam_e[k][1] and close(fam[k][0], fam_e[k][0])
                 for k in fam),
         f"device events: raw kineto {busy} µs / {n_kernels} / {fam}, "
         f"prof.events() {busy_e} µs / {n_e} / {fam_e}")
    tops = dict(device_tops(prof, n_kernels))
    avgs = {ev.key: (ev.device_time_total, ev.count)
            for ev in prof.key_averages() if ev.device_type == cuda}
    need(tops.keys() == avgs.keys()
         and all(tops[k][1] == avgs[k][1] and close(tops[k][0], avgs[k][0])
                 for k in tops),
         f"device events: {len(tops)} names from raw kineto, "
         f"{len(avgs)} from key_averages(), or their sums differ")
    report(f"device events read from the raw kineto results == the "
           f"profiler's: busy {busy:.3f} µs (prof.events() "
           f"{busy_e:.3f}), {n_kernels} events, families "
           f"{sorted(fam)}, {len(tops)} names with equal sums and counts "
           f"in key_averages()")


def profile_step(engine, report, label="planned",
                 witness=False) -> None:
    """One decode step under ``torch.profiler``: wall time, device busy
    time (sum of kernel time) and its breakdown by kernel family.  A
    measurement only — a profiler that records nothing is reported, not
    fatal.  ``witness``: ``check_device_events`` on this profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy, n_kernels, fam = device_breakdown(prof)
    if not busy:
        report(f"profiled {label} decode step: the profiler recorded no "
               "device time (not measured)")
        return
    if witness:
        check_device_events(prof, report)
    report(f"profiled {label} decode step: wall {wall * 1e3:.2f} ms, device "
           f"busy {busy / 1e3:.2f} ms ({100 * busy / 1e3 / (wall * 1e3):.1f}%"
           f" of wall, {n_kernels} kernels); device ms and launches by "
           f"kernel: {fam}")


def make_prompts(cfg):
    import numpy as np
    rng = np.random.default_rng(0)
    # 8-16 prompt tokens (8-48 up to PR 23): every engine of phases 4-7
    # feeds them a token at a time, host-paced, so they set those phases'
    # wall time
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 17)))
            for _ in range(8)]


def make_engine(cfg, params, exec_cfg, fused, **kw):
    """A phase 4-7 engine: whole-prompt admission and synchronous blocks
    (each block read before the next is launched), as in earlier runs, so
    their times stay comparable; phase 13 drives the rest."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    kw.setdefault("async_dispatch", False)
    return ServeEngine(cfg, params, n_slots=N_SLOTS, max_seq=96,
                       dtype=torch.bfloat16, exec_cfg=exec_cfg, fused=fused,
                       decode_block=16, device="cuda", **kw)


def drain_timed(eng, prompts, max_new):
    """Serve ``prompts`` to the end through ``eng``'s fused blocks; returns
    (streams, wall seconds, {prefill s, decode s, decode steps}).  The
    prefill feed and each block launch run to the device's end inside
    their timers (the engine reads each block synchronously anyway)."""
    import torch
    timing = {"prefill": 0.0, "decode": 0.0, "steps": 0}
    feed, dispatch = eng._feed_prefill, eng._dispatch_block

    def timed_feed(i, start, count):
        torch.cuda.synchronize()
        t = time.perf_counter()
        feed(i, start, count)
        torch.cuda.synchronize()
        timing["prefill"] += time.perf_counter() - t

    def timed_dispatch(live, t_block, *carries):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = dispatch(live, t_block, *carries)
        torch.cuda.synchronize()
        timing["decode"] += time.perf_counter() - t
        timing["steps"] += n
        return n

    eng._feed_prefill, eng._dispatch_block = timed_feed, timed_dispatch
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    streams = [res[u] for u in uids]
    need(all(len(st) == max_new for st in streams), "fused run lost tokens")
    return streams, wall, timing


def rate_line(streams, wall, timing) -> str:
    n_tok = sum(len(st) for st in streams)
    return (f"{n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s "
            f"(prefill {timing['prefill']:.2f} s, decode "
            f"{timing['decode']:.2f} s over {timing['steps']} steps = "
            f"{1e3 * timing['decode'] / timing['steps']:.2f} ms per decode "
            f"step)")


def run_engines(cfg, params, planned, dense, report):
    """Phases 4-5.  Returns the main-path launches and the bf16 planned
    engine's prompts, streams and first-step logits."""
    import torch

    prompts = make_prompts(cfg)
    max_new = 32

    # --- phase 4: planned engine, fused vs oracle ---
    reset_launches()
    eng = make_engine(cfg, params, planned, True)
    fused, wall, timing = drain_timed(eng, prompts, max_new)
    counts = launch_counts()
    planned_counts = {k: counts[k] for k in SLICE1_KERNELS}
    report(f"planned engine: {rate_line(fused, wall, timing)}; launches "
           f"{planned_counts}")

    oracle = make_engine(cfg, params, planned, False)
    ouids = [oracle.submit(p, max_new=max_new) for p in prompts]
    oracle.step()                          # admits 4, decodes one step
    logits0 = oracle.last_logits.clone()
    profile_step(oracle, report, witness=True)
    ores = oracle.run_until_drained()
    same = all(ores[o] == fused[i] for i, o in enumerate(ouids))
    report(f"fused streams == step() oracle: {same}")
    need(same, "fused streams differ from the step() oracle")
    need(bool(torch.isfinite(logits0).all()), "non-finite logits")
    need(logits0.shape == (N_SLOTS, cfg.vocab), "bad logits shape")

    # --- phase 5: dense descriptor-table engines and the plain engine ---
    # Tolerance for a different float32 summation order: 5% of max |logit|.
    # Every matmul's bf16 output is re-rounded, so 1-ulp (2⁻⁸) differences
    # compound through 24 layers' residual stream; the per-site checks of
    # phase 3 are the tight ones.
    tol = 0.05 * logits0.abs().max().item()

    forced_logits = {}
    for label, ec in (("dense, selected schedule", dense),
                      ("dense, all sites weight-stationary",
                       forced(dense, "weight")),
                      ("dense, all sites input-stationary",
                       forced(dense, "input")),
                      ("plain torch.matmul, no kernels", None)):
        e = make_engine(cfg, params, ec, False)
        for p in prompts[:N_SLOTS]:
            e.submit(p, max_new=max_new)
        e.step()
        forced_logits[label] = e.last_logits.clone()
        diff = (e.last_logits - logits0).abs().max().item()
        if ec is dense:
            report(f"{label}: step logits vs planned max |diff| = "
                   f"{diff:.3e} (must be 0)")
            need(diff == 0.0, "dense engine differs from the planned one")
        else:
            report(f"{label}: step logits vs planned max |diff| = "
                   f"{diff:.3e}, tol {tol:.3e}")
            need(diff <= tol, f"{label}: logits off by {diff}")
    same = torch.equal(forced_logits["dense, all sites input-stationary"],
                       forced_logits["dense, all sites weight-stationary"])
    report(f"all sites input-stationary == all sites weight-stationary, "
           f"step logits bit for bit: {same}")
    need(same, "the input-stationary engine's logits differ from the "
         "weight-stationary engine's")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in SLICE1_KERNELS}
    report(f"main-path launches (phases 4-5): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched on the main path")
    return launches, {"prompts": prompts, "streams": fused,
                      "logits0": logits0}


# ---------------------------------------------------------------------------
# phases 6-7: int8 serving (quantize=True) on the same weights
# ---------------------------------------------------------------------------

def check_int8_site(pw, e, m, gen, report, label) -> dict:
    """One site of the int8 path — its attached layer-0 weight ``pw`` under
    the plan entry ``e`` — at M = ``m``: ``block_sparse_matmul(scale=,
    rows=m)`` on the planned operands and ``int8_matmul``, with bf16 and
    float32 activations, dense and with half their K-blocks zero, each held
    to ``matmul_tol`` with B = Q·s against its plain version; the scaled
    run bitwise against its all-live run and against ``int8_matmul``; a
    float32 tolerance that must reject a TF32 activation.  Returns the
    worst error per kernel and the dense float32 activation."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                         int8_matmul_plain)
    from repro_torch.quant.quantize import QuantizedLinear

    need(pw.quantized and not e.transpose,
         f"{e.site}: the int8 plan did not attach an int8 payload")
    qw = QuantizedLinear(pw.w, pw.qscale)
    w_deq = pw.w_kn                       # float32 Q·s
    k, n = pw.kn.shape
    a_full = torch.randn((m, k), generator=gen, device=gen.device)
    kb = torch.rand(-(-k // e.bk), generator=gen, device=gen.device) < 0.5
    a_half = a_full * kb.repeat_interleave(e.bk)[:k]
    worst = dict.fromkeys(INT8_KERNELS, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        errs = dict.fromkeys(worst, 0.0)
        tol = 0.0
        for act, a32 in (("dense", a_full), ("half", a_half)):
            a = a32.to(dtype)
            tol_a = matmul_tol(a, w_deq)
            tol = max(tol, tol_a)
            what = f"{label} {e.site} {dtype} {act}"
            xp, wp, meta, scale = planned_operands(a, pw)
            out = bs.block_sparse_matmul(xp, wp, meta, scale=scale,
                                         out_dtype=torch.float32, rows=m)
            err = (out - block_sparse_matmul_ref(xp, wp, meta, scale)[:m]) \
                .abs().max().item()
            need(err <= tol_a, f"block_sparse_scaled {what}: error {err} > "
                 f"{tol_a}")
            need(torch.equal(out, bs.block_sparse_matmul(
                xp, wp, all_live(meta), scale=scale,
                out_dtype=torch.float32, rows=m)),
                f"block_sparse_scaled {what}: sparse != all-live run")
            errs["block_sparse_scaled"] = max(errs["block_sparse_scaled"],
                                              err)
            d = int8_matmul(a, qw, out_dtype=torch.float32)
            err = (d - int8_matmul_plain(a, qw.q, qw.scale)).abs().max() \
                .item()
            need(err <= tol_a, f"int8_matmul {what}: error {err} > {tol_a}")
            need(torch.equal(d, out[:, :n]), f"{what}: int8_matmul != "
                 f"block_sparse_scaled bitwise")
            errs["int8_matmul"] = max(errs["int8_matmul"], err)
        line = (f"{label} {e.site} {str(dtype)[6:]} M={m} K={k} N={n}: "
                f"block_sparse_scaled ({e.bm},{e.bk},{e.bn}) "
                f"{errs['block_sparse_scaled']:.3e}, int8_matmul "
                f"{errs['int8_matmul']:.3e}; tol {tol:.3e}; sparse == "
                f"all-live == int8_matmul bitwise")
        if dtype is torch.float32:
            a = a_full
            xp, wp, meta, scale = planned_operands(a, pw)
            tol_a = matmul_tol(a, w_deq)
            ctrl_bs = (block_sparse_matmul_ref(tf32(xp), wp, meta, scale)
                       - block_sparse_matmul_ref(xp, wp, meta, scale)) \
                .abs().max().item()
            ctrl_i8 = (int8_matmul_plain(tf32(a), qw.q, qw.scale)
                       - int8_matmul_plain(a, qw.q, qw.scale)) \
                .abs().max().item()
            line += (f"; TF32 control {ctrl_bs:.3e} / {ctrl_i8:.3e} "
                     f"(must exceed tol)")
            need(min(ctrl_bs, ctrl_i8) > tol_a,
                 f"{label} {e.site}: the float32 tolerance does not reject "
                 f"a TF32 activation ({ctrl_bs}, {ctrl_i8})")
        report(line)
        for key in worst:
            worst[key] = max(worst[key], errs[key])
    return worst, a_full


def check_sites_int8(cfg, params, q8, report) -> dict:
    """Every site of the int8 path at layer 0 (``check_int8_site``): the
    quantized plan's blocks and metadata, the decode shape, and bf16 times.
    Returns the worst error per kernel and the bf16 mlp.in operands for
    the ``kernels`` line."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                         int8_matmul_plain)
    from repro_torch.quant.quantize import QuantizedLinear, quantize_params

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(2)
    qparams, _ = quantize_params(params, tie_embeddings=cfg.tie_embeddings)
    attached = q8.plan.attach(qparams)
    worst = dict.fromkeys(INT8_KERNELS, 0.0)
    keep = {}
    for e in q8.plan.entries.values():
        pw = attached
        for key in e.path:
            pw = pw[key]
        if e.lead:
            pw = pw.index(0)
        m = q8.schedules.sites[e.site].m
        errs, a_full = check_int8_site(pw, e, m, gen, report, "int8")
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        # bf16 times at this site, activation dense as on the path
        qw = QuantizedLinear(pw.w, pw.qscale)
        k, n = pw.kn.shape
        a = a_full.to(torch.bfloat16)
        xp, wp, meta, scale = planned_operands(a, pw)
        b_bs, _ = bs_bound_ms(xp, meta, (e.bm, e.bk, e.bn), w_elem=1,
                              scale_elem=4)
        b_i8, _ = bound_ms(a.numel() * 2 + k * n + 4 * n + m * n * 4,
                           2.0 * m * n * k)
        t_bs = cuda_ms(lambda: bs.block_sparse_matmul(
            xp, wp, meta, scale=scale, out_dtype=torch.float32, rows=m))
        t_i8 = cuda_ms(lambda: int8_matmul(a, qw, out_dtype=torch.float32))
        t_pbs = cuda_ms(lambda: block_sparse_matmul_ref(xp, wp, meta, scale))
        t_pi8 = cuda_ms(lambda: int8_matmul_plain(a, qw.q, qw.scale))
        w_bf16 = pw.w_kn.to(torch.bfloat16)
        t_bf16 = cuda_ms(lambda: torch.matmul(a, w_bf16))
        report(f"  int8 {e.site} bf16 ms: block_sparse_scaled {t_bs:.4f} "
               f"(bound {b_bs:.5f}), int8_matmul {t_i8:.4f} (bound "
               f"{b_i8:.5f}), plain {t_pbs:.4f} / {t_pi8:.4f}, bf16 "
               f"torch.matmul on the dequantized weight {t_bf16:.4f}")
        if e.site == "mlp.in":
            keep.update(a=a, qw=qw, xp=xp, wp=wp, meta=meta, scale=scale,
                        blocks=(e.bm, e.bk, e.bn), w_bf16=w_bf16)
    need(bool(keep), "no mlp.in site in the int8 plan")
    torch.cuda.synchronize()
    keep["errs"] = worst
    return keep


def run_int8_engines(cfg, params, q8, dense8, bf16, report) -> dict:
    """Phase 7: the int8 engines on the first 4 prompts.  Returns the int8
    path's launches."""
    import torch

    prompts = bf16["prompts"][:N_SLOTS]
    max_new = 16
    reset_launches()
    eng = make_engine(cfg, params, q8, True)
    streams, wall, timing = drain_timed(eng, prompts, max_new)
    report(f"planned int8 engine: {rate_line(streams, wall, timing)}; "
           f"weights {eng.quant_stats['quantized_bytes']} bytes int8 + "
           f"scales vs {eng.quant_stats['original_bytes']} bf16")

    oracle = make_engine(cfg, params, q8, False)
    ouids = [oracle.submit(p, max_new=max_new) for p in prompts]
    oracle.step()
    logits8 = oracle.last_logits.clone()
    profile_step(oracle, report, "planned int8")
    ores = oracle.run_until_drained()
    same = all(ores[o] == streams[i] for i, o in enumerate(ouids))
    report(f"int8 fused streams == step() oracle: {same}")
    need(same, "int8 fused streams differ from the step() oracle")
    need(bool(torch.isfinite(logits8).all()), "non-finite int8 logits")
    need(logits8.shape == (N_SLOTS, cfg.vocab), "bad int8 logits shape")

    # the dense table runs int8_matmul at every site: same tile template,
    # same per-element summation order (K ascending), dead blocks add exact
    # zeros, the scale applied to the same accumulator — so the same bits
    tol = 0.05 * logits8.abs().max().item()
    for label, ec, kw in (("dense int8 table (int8_matmul)", dense8, {}),
                          ("plain int8 (bf16 dequantized, torch.matmul)",
                           None, {"quantize": True})):
        e = make_engine(cfg, params, ec, False, **kw)
        for p in prompts:
            e.submit(p, max_new=max_new)
        e.step()
        diff = (e.last_logits - logits8).abs().max().item()
        if ec is dense8:
            report(f"{label}: step logits vs planned int8 max |diff| = "
                   f"{diff:.3e} (must be 0)")
            need(diff == 0.0, "dense int8 engine differs from the planned "
                 "int8 one")
        else:
            report(f"{label}: step logits vs planned int8 max |diff| = "
                   f"{diff:.3e}, tol {tol:.3e}")
            need(diff <= tol, f"{label}: logits off by {diff}")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in INT8_KERNELS}
    report(f"main-path launches (phase 7): {counts}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched on the int8 path")

    ref = [st[:max_new] for st in bf16["streams"][:N_SLOTS]]
    agree = sum(x == y for st, rt in zip(streams, ref)
                for x, y in zip(st, rt))
    prefix = [next((i for i, (x, y) in enumerate(zip(st, rt)) if x != y),
                   max_new) for st, rt in zip(streams, ref)]
    report(f"information: int8 vs bf16 planned first-step logits max |diff| "
           f"= {(logits8 - bf16['logits0']).abs().max().item():.3e}; greedy "
           f"tokens equal at {agree}/{N_SLOTS * max_new} positions, common "
           f"prefixes {prefix}")
    return launches


def int8pack(a, qw):
    """PyTorch's one call of a bf16 x int8 product with per-column scales,
    ``torch._weight_int8pack_mm(A, Qᵀ, scale)``: it rounds the scales to
    A's dtype, so it is a yardstick of speed, not the same function.
    Returns (a callable, its max |difference| from the plain version) or
    (None, the first line of the error it raises on these inputs)."""
    import torch
    from repro_torch.kernels.ref import int8_matmul_plain
    qt, sc = qw.q.t().contiguous(), qw.scale.to(a.dtype)

    def call():
        return torch._weight_int8pack_mm(a, qt, sc)

    try:
        out = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, str(exc).strip().splitlines()[0][:200]
    diff = (out.float() - int8_matmul_plain(a, qw.q, qw.scale)).abs().max()
    return call, diff.item()


def time_int8_kernels(t, launches) -> list:
    """The int8 rows of the ``kernels`` line: bf16 x @ w_in at the decode
    shape (M=4, K=2048, N=5632), the weight block-pruned at (256, 256) and
    quantized, the activation dense."""
    import torch
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels.ref import (block_sparse_matmul_ref,
                                         int8_matmul_plain)

    a, qw, meta = t["a"], t["qw"], t["meta"]
    xp, wp, scale = t["xp"], t["wp"], t["scale"]
    m, k = a.shape
    n = qw.q.shape[1]
    saved = launch_counts()
    b_bs, by_bs = bs_bound_ms(xp, meta, t["blocks"], w_elem=1,
                              scale_elem=4)
    b_i8, by_i8 = bound_ms(a.numel() * 2 + k * n + 4 * n + m * n * 4,
                           2.0 * m * n * k)
    lib, lib_note = int8pack(a, qw)
    lib_ms = lib_device_ms = None
    if lib is not None:
        lib_ms, lib_device_ms = cuda_ms(lib), device_ms(lib)

    def bs_call():
        return bs.block_sparse_matmul(xp, wp, meta, scale=scale,
                                      out_dtype=torch.float32, rows=m)

    def i8_call():
        return int8_matmul(a, qw, out_dtype=torch.float32)

    rows = [{
        "name": "block_sparse_scaled", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_sparse.cu",
        "replaces": "src/repro/kernels/block_sparse.py:69",
        "launches": launches["block_sparse_scaled"],
        "launches_sum": launches["block_sparse_scaled_sum"],
        "max_abs_err": t["errs"]["block_sparse_scaled"],
        "ms": cuda_ms(bs_call),
        "plain_ms": cuda_ms(lambda: block_sparse_matmul_ref(xp, wp, meta,
                                                            scale)),
        "bound_ms": b_bs, "bound_by": by_bs, "library_ms": lib_ms,
        "device_ms": device_ms(bs_call)}, {
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:24",
        "launches": launches["int8_matmul"],
        "launches_sum": launches["int8_matmul_sum"],
        "max_abs_err": t["errs"]["int8_matmul"],
        "ms": cuda_ms(i8_call),
        "plain_ms": cuda_ms(lambda: int8_matmul_plain(a, qw.q, qw.scale)),
        "bound_ms": b_i8, "bound_by": by_i8, "library_ms": lib_ms,
        "device_ms": device_ms(i8_call)}]
    # reference point, not a library time: bf16 x bf16 on the dequantized
    # weight (timed last, after the kernels have warmed the card)
    bf16_ms = cuda_ms(lambda: torch.matmul(a, t["w_bf16"]))
    for row in rows:
        row.update(bf16_matmul_ms=bf16_ms, library_device_ms=lib_device_ms,
                   library="torch._weight_int8pack_mm (scales rounded to "
                   "bf16: a yardstick, not the same function)",
                   library_note=lib_note)
    reset_launches(saved)
    return rows


# ---------------------------------------------------------------------------
# phase 23: the serve executables — every entry point of the engine a
# replayed CUDA graph (StableLM-1.6B after phase 8, DeepSeek-MoE-16B in
# phase 15)
# ---------------------------------------------------------------------------

P23_BLOCK = 16               # decode_block: blocks of 16, feeds of <= 16
P23_NEW = 64                 # new tokens a request may take (stays live)
P23_ADMIT = (16, 64, 512)    # prompt tokens of the admission timings
P23_ADMIT_EAGER = (16,)      # ... also timed on the eager entry points


def eager_entries(eng):
    """``eng`` with every entry point run by its eager function: the plain
    version of a replay.  A switch of this script's, not of the engine,
    which has no eager path on the card."""
    import torch
    from repro_torch.serve.executables import Executable
    cpu = torch.device("cpu")        # an Executable off CUDA calls fn

    def entry(key, fn, warm):
        if key not in eng._executables:
            eng._executables[key] = Executable(key[0], key[1:], fn, warm,
                                               cpu)
        return eng._executables[key]
    eng._entry = entry
    return eng


def p23_engine(cfg, params, exec_cfg, **kw):
    """Phase 23's engine: 4 slots, blocks of 16, synchronous reads."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    kw.setdefault("max_seq", 96)
    return ServeEngine(cfg, params, n_slots=N_SLOTS, dtype=torch.bfloat16,
                       exec_cfg=exec_cfg, decode_block=P23_BLOCK,
                       async_dispatch=False, device="cuda", **kw)


def tree_copy(tree):
    from repro_torch.core.sparsity import map_leaves
    return map_leaves(lambda _, t: t.clone(), tree)


def tree_load(dst, src) -> None:
    from repro_torch.core.sparsity import iter_leaves
    for (_, a), (_, b) in zip(iter_leaves(dst), iter_leaves(src)):
        a.copy_(b)


def same_tree(a, b) -> bool:
    import torch
    from repro_torch.core.sparsity import iter_leaves
    return all(torch.equal(bits(x), bits(y)) for (_, x), (_, y) in
               zip(iter_leaves(a), iter_leaves(b)))


def graph_stats(eng) -> dict:
    """Captured graphs of ``eng``: count, seconds of warm runs, captures
    and instantiation, and the graph pool's bytes."""
    exs = [e for e in eng._executables.values() if e.graph is not None]
    return {"graphs": len(exs),
            "capture_s": round(sum(e.capture_s for e in exs), 3),
            "pool_bytes": sum(e.pool_bytes for e in exs)}


def p23_block(eng, report, card, label, t=P23_BLOCK) -> dict:
    """From ``eng``'s live rows, one fused block of ``t`` steps: the replay
    against ``model.decode_many`` on a copy of the state (block, carries,
    every state leaf bit for bit; the launches the replay credits == those
    the eager call counts); ms per decode step eager and replayed from the
    same state, each twice in turns; one profiled replay; synchronizing
    calls of a replayed block launched and read by the engine.  The state
    is put back after."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_lib
    live = eng._live()
    args = (eng._to_device(eng._current_tokens(live)),
            eng._to_device(eng._slot_positions()), eng._live_mask(live),
            eng._to_device(eng._slot_budgets(live)))
    tier = eng._block_tier(live)
    ex = eng._block_exec(tier, t, False)
    snap = tree_copy(eng.state)
    eng._run(ex, *eng._dead_rows(False))      # captured if it was not

    def eager(st):
        with eng._scope():
            return model_lib.decode_many(
                eng._tier_params[tier], eng.cfg, args[0], st, args[1],
                args[2], t, rem=args[3], eos_id=eng.eos_id,
                nan_guard=eng.nan_guard)
    torch.cuda.synchronize()
    c0 = launch_counts()
    got = eng._run(ex, *args)
    c1 = launch_counts()
    want_block, want_st, *want_car = eager(tree_copy(snap))
    c2 = launch_counts()
    torch.cuda.synchronize()
    same_tok = all(torch.equal(a, b) for a, b in
                   zip(got, (want_block, *want_car)))
    same_st = same_tree(eng.state, want_st)
    d_replay = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    d_eager = {k: c2[k] - c1[k] for k in c2 if c2[k] != c1[k]}
    report(f"{label}: replayed block of {t} == model.decode_many on a copy "
           f"of the state: tokens and carries {same_tok}, every state leaf "
           f"bit for bit {same_st}; launches credited by the replay "
           f"{d_replay} == the eager call's: {d_replay == d_eager}")
    need(same_tok and same_st, f"{label}: the replayed block differs from "
         f"the eager one")
    need(d_replay == d_eager and d_replay, f"{label}: the replay credited "
         f"{d_replay}, the eager call launched {d_eager}")
    scratch = tree_copy(snap)
    ms = {"eager": [], "replayed": []}
    for mode in ("eager", "replayed", "replayed", "eager"):
        tree_load(scratch if mode == "eager" else eng.state, snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "eager":
            eager(scratch)
        else:
            eng._run(ex, *args)
        torch.cuda.synchronize()
        ms[mode].append(1e3 * (time.perf_counter() - t0) / t)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    tree_load(eng.state, snap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng._run(ex, *args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n_kernels, fam = device_breakdown(prof)
    tree_load(eng.state, snap)
    busy_step = busy / 1e3 / t
    share = busy_step / mean["replayed"] if busy else None
    report(f"{label}: ms per decode step ({len(live)} live rows, blocks of "
           f"{t}): eager {[round(x, 3) for x in ms['eager']]}, replayed "
           f"{[round(x, 3) for x in ms['replayed']]}; means eager "
           f"{mean['eager']:.3f}, replayed {mean['replayed']:.3f} "
           f"({mean['eager'] / mean['replayed']:.2f}x), tokens/s eager "
           f"{1e3 * len(live) / mean['eager']:.1f}, replayed "
           f"{1e3 * len(live) / mean['replayed']:.1f} ({card})")
    report(f"{label}: one profiled replayed block: device busy "
           f"{busy / 1e3:.2f} ms over {n_kernels} kernels = {busy_step:.3f} "
           f"ms a step, {100 * share:.1f}% of the unprofiled replay's "
           f"{mean['replayed']:.3f} ms (under the profiler the block's wall "
           f"was {1e3 * wall:.1f} ms: {100 * busy / 1e3 / (1e3 * wall):.1f}"
           f"%); by family {fam} ({card})" if busy else
           f"{label}: profiled replay recorded no device time (not "
           f"measured)")
    torch.cuda.synchronize()
    sites = []
    syncs = count_syncs(lambda: (eng._launch(live, t), eng._account_one()),
                        sites)
    report(f"{label}: synchronizing calls in one replayed block launched "
           f"and read by the engine: {syncs} {sites}")
    need(syncs == 0, f"{label}: a replayed block made {syncs} "
         f"synchronizing calls")
    return {"eager_ms": round(mean["eager"], 3),
            "replayed_ms": round(mean["replayed"], 3),
            "tokens_per_s_eager": round(1e3 * len(live) / mean["eager"], 1),
            "tokens_per_s_replayed": round(1e3 * len(live)
                                           / mean["replayed"], 1),
            "busy_ms_per_step": round(busy_step, 3) if busy else None,
            "busy_share": round(share, 4) if busy else None,
            "kernels_per_step": n_kernels // t if busy else None}


def p23_live(eng, prompts):
    """Submit ``prompts`` (``P23_NEW`` new tokens each) and tick until every
    slot decodes: admission and the first block replayed."""
    for p in prompts:
        eng.submit(p, max_new=P23_NEW)
    while len(eng._live()) < len(prompts):
        eng.decode_block_step()


def p23_feed(eng, report, label, n_prompt=22) -> None:
    """A free slot takes an ``n_prompt``-token prompt: its feed of
    ``n_prompt`` - 1 tokens runs as a replay of 16 positions and one of 8
    (5 tokens padded); the state equals one unpadded eager
    ``prefill_into_slot`` on a copy, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib
    uid = eng.slots[N_SLOTS - 1].req.uid
    eng.cancel(uid)
    prompt = np.arange(100, 100 + n_prompt)
    eng.submit(prompt, max_new=P23_NEW)
    copy = tree_copy(eng.state)
    slot_pos = eng._to_device(eng._slot_positions())
    before = {k: e.replays for k, e in eng._executables.items()}
    eng._admit()
    fed = {k[1]: e.replays - before.get(k, 0)
           for k, e in eng._executables.items()
           if k[0] == "feed" and e.replays != before.get(k, 0)}
    with eng._scope():
        model_lib.prefill_into_slot(
            eng._exec_params, eng.cfg, prompt[:-1], np.ones(n_prompt - 1,
                                                            bool),
            N_SLOTS - 1, copy, slot_pos, 0, True)
    torch.cuda.synchronize()
    same = same_tree(eng.state, copy)
    report(f"{label}: a {n_prompt - 1}-token feed replayed as {fed} (length:"
           f" replays) == one unpadded eager prefill_into_slot, every state "
           f"leaf bit for bit: {same}")
    need(same and fed == {16: 1, 8: 1}, f"{label}: the padded, split feed "
         f"({fed}) differs from the eager feed")


def p23_admission(cfg, params, exec_cfg, report, card) -> dict:
    """ms per prompt token of admitting one prompt of each ``P23_ADMIT``
    length into an engine of ``max_seq`` 640 whose feed is captured (after
    one 16-token admission), and of ``P23_ADMIT_EAGER`` on the eager entry
    points."""
    import numpy as np
    import torch
    out = {}
    for mode in ("replayed", "eager"):
        eng = p23_engine(cfg, params, exec_cfg, max_seq=640)
        if mode == "eager":
            eager_entries(eng)
        lens = P23_ADMIT if mode == "replayed" else P23_ADMIT_EAGER
        for n in (16,) + lens:
            uid = eng.submit(np.arange(7, 7 + n) % cfg.vocab, max_new=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng._admit()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            eng.cancel(uid)
            out[(mode, n)] = 1e3 * dt / n
        del eng
        free()
    ms = {f"{m} {n}": round(v, 3) for (m, n), v in out.items()}
    report(f"admission, ms per prompt token (whole prompt, feeds of <= "
           f"{P23_BLOCK}; the first of each mode captures or warms): {ms} "
           f"({card})")
    return {f"{m}_{n}": round(v, 4) for (m, n), v in out.items()}


def p23_planted_sync(cfg, params, exec_cfg, report) -> None:
    """The control that must fail: ``model.decode_many`` with a planted
    ``.item()`` cannot be captured, and the engine raises ``CaptureError``
    naming the entry point (no eager fallback)."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.serve.executables import CaptureError
    eng = p23_engine(cfg, params, exec_cfg)
    real = model_lib.decode_many

    def planted(*a, **kw):
        out = real(*a, **kw)
        out[0].sum().item()
        return out
    model_lib.decode_many = planted
    try:
        eng._run(eng._block_exec(0, 2, False), *eng._dead_rows(False))
        raised = None
    except CaptureError as err:
        raised = str(err)
    finally:
        model_lib.decode_many = real
    report(f"control: a planted .item() in decode_many raises at capture: "
           f"{raised is not None} ({(raised or '')[:160]})")
    need(raised is not None and "decode_many" in raised,
         "the planted synchronizing call was captured or ran eagerly")
    # the failed capture must leave the allocator out of capture mode
    # (else empty_cache releases nothing and a later phase runs out of
    # memory): a freed GiB goes back with empty_cache
    del eng
    free()
    x = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    held = torch.cuda.memory_reserved()
    del x
    free()
    after = torch.cuda.memory_reserved()
    report(f"after the failed capture, a freed GiB is released: reserved "
           f"{held / 2**30:.2f} GiB while held, {after / 2**30:.2f} after")
    need(after < held, "a failed capture left the allocator holding freed "
         "memory")


def run_executables(cfg, params, planned, q8, bf16, report, card) -> dict:
    """Phase 23 on StableLM-1.6B (24 layers, 4 slots): the bf16 planned
    two-sided engine's warmup (every shape captured: seconds, graphs, pool
    bytes, state bit-unchanged), block gates and times (``p23_block``), the
    padded split feed (``p23_feed``), admission times, the first wave of
    phase 4's prompts on the eager entry points (streams equal phase 4's
    replayed ones), the int8 planned engine's block gates and times, and
    the planted-sync control.  The launches of the phase are put back."""
    import torch
    saved = launch_counts()
    t_phase = time.perf_counter()
    out = {}
    eng = p23_engine(cfg, params, planned)
    before = tree_copy(eng.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    stats = graph_stats(eng)
    same = same_tree(eng.state, before)
    report(f"bf16 planned warmup: {warm_s:.2f} s, {stats} (blocks of 1-16, "
           f"feeds of 1-16, the step), state bit-unchanged {same} ({card})")
    need(same, "phase 23: warmup changed the decode state")
    out["bf16_warmup"] = dict(stats, warmup_s=round(warm_s, 3))
    p23_live(eng, bf16["prompts"][:N_SLOTS])
    out["bf16"] = p23_block(eng, report, card, "bf16 planned")
    p23_feed(eng, report, "bf16 planned")
    del eng
    free()
    out["admission"] = p23_admission(cfg, params, planned, report, card)
    # the first wave of phase 4's traffic on the eager entry points, 8 of
    # its 32 tokens (16 up to PR 27)
    eng = eager_entries(make_engine(cfg, params, planned, True))
    streams, wall, _ = drain_timed(eng, bf16["prompts"][:N_SLOTS], 8)
    same = streams == [x[:8] for x in bf16["streams"][:N_SLOTS]]
    report(f"phase 4's first {N_SLOTS} prompts x 8 on the eager entry "
           f"points ({wall:.2f} s): streams == the replayed engine's: "
           f"{same}")
    need(same, "phase 23: eager streams differ from the replayed ones")
    del eng
    free()
    eng = p23_engine(cfg, params, q8)
    t0 = time.perf_counter()
    p23_live(eng, bf16["prompts"][:N_SLOTS])
    report(f"int8 planned engine: admission and the first block "
           f"{time.perf_counter() - t0:.2f} s, {graph_stats(eng)}")
    out["int8"] = p23_block(eng, report, card, "int8 planned")
    out["int8_graphs"] = graph_stats(eng)
    del eng
    free()
    p23_planted_sync(cfg, params, planned, report)
    reset_launches(saved)
    report(f"phase 23 (StableLM-1.6B) wall time: "
           f"{time.perf_counter() - t_phase:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phases 9-11: long-prompt prefill at B·S = 8192
# ---------------------------------------------------------------------------

FLASH_CASES = (  # (label, BH, Sq, Skv, causal, window); hd = 64
    ("cell, causal", 64, 4096, 4096, True, 0),
    ("Sq < Skv, causal", 64, 128, 4096, True, 0),
    ("window 1024", 64, 4096, 4096, True, 1024),
    ("non-causal", 64, 4096, 4096, False, 0),
)


def prefill_shape(report=None):
    """``SHAPES["prefill_32k"]`` cut to 2 prompts of 4096 tokens."""
    from repro_torch.configs import SHAPES
    full = SHAPES["prefill_32k"]
    shape = dataclasses.replace(full, seq_len=4096, global_batch=2)
    if report is not None:
        report(f"prefill shape: {full.name} ({full.global_batch} x "
               f"{full.seq_len}) cut to {shape.global_batch} x "
               f"{shape.seq_len}: 4096 is StableLM-1.6B's published context "
               f"length and above the 2048 tokens where attention takes the "
               f"flash branch; the float64 dense reference of one layer's "
               f"attention (2·32·4096² scores) fits on the card at that "
               f"length and would not at 32k")
    return shape


def dense_ref64(q, k, v, causal=True, window=0):
    """The dense softmax oracle in float64, eight heads at a time."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref
    return torch.cat([flash_attention_ref(
        q[i:i + 8].double(), k[i:i + 8].double(), v[i:i + 8].double(),
        causal=causal, window=window) for i in range(0, q.shape[0], 8)])


def flash_tol(q, k, v) -> float:
    """Float32 flash attention against the exact (float64) softmax.  With
    ε = 2⁻²⁴ and S = hd^-0.5·max(|q|@|k|ᵀ) (a bound on |score|): each score
    errs by ≤ √hd·ε·S (random-sign sums, as in ``matmul_tol``) + ε·S (the
    scaling); a weight p = exp(s - m) then errs relatively by twice that
    plus ε·2S (the subtraction) + ε (expf); the rescales add 2ε per kv block
    of 64 and the sums √Skv·ε; an output o = Σ w·v moves by at most
    2·max|v| times the weights' relative error.  So ε·max|v|·(4(√hd + 2)S
    + 2·n_blocks + 2√Skv + 2).  Operands cut to TF32's 10-bit mantissa err
    by ~2⁻¹¹ per element and land outside it on a causal case, whose first
    rows carry v almost unaveraged (checked)."""
    import torch
    hd, skv = q.shape[2], k.shape[1]
    s_max = hd ** -0.5 * max(
        torch.matmul(q[i:i + 1].abs().double(),
                     k[i:i + 1].abs().double().transpose(1, 2)).max().item()
        for i in range(q.shape[0]))
    return 2.0 ** -24 * v.abs().max().item() * (
        4 * (hd ** 0.5 + 2) * s_max + 2 * (skv // 64) + 2 * skv ** 0.5 + 2)


def check_flash(report, cases=FLASH_CASES, hd=64, seed=3) -> dict:
    """Phase 9a (and the head-dim-256 checks of phases 16-17): each case
    of ``cases`` at head dim ``hd``.  Returns the worst error and the bf16
    operands of the first case, the cell.  The bf16 kernel sums its scores
    on the tensor cores, so it is held to the tensor-core tolerance
    (``ref.flash_tc_check``), which three controls must fail; the float32
    tolerance must reject TF32 operands on the cell."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import (SHARE_ROOM,
                                         flash_attention_flip_bounds,
                                         flash_attention_plain,
                                         flash_tc_check)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst, keep = 0.0, {}
    for i, (label, bh, sq, skv, causal, window) in enumerate(cases):
        kw = dict(causal=causal, window=window)
        q = torch.randn((bh, sq, hd), generator=gen, device=dev)
        k, v = (torch.randn((bh, skv, hd), generator=gen, device=dev)
                for _ in range(2))
        exact = dense_ref64(q, k, v, **kw)
        err32 = (flash_attention(q, k, v, **kw).double() - exact) \
            .abs().max().item()
        tol = flash_tol(q, k, v)
        need(err32 <= tol, f"flash {label} float32: error {err32} > {tol}")
        line = (f"flash {label} (BH={bh}, Sq={sq}, Skv={skv}, hd={hd}): "
                f"float32 vs float64 dense {err32:.3e}, tol {tol:.3e}")
        if i == 0:
            ctrl = (dense_ref64(tf32(q), tf32(k), tf32(v), **kw) - exact) \
                .abs().max().item()
            need(ctrl > tol, f"flash {label}: the float32 tolerance does not "
                 f"reject TF32 operands ({ctrl})")
            line += f", TF32 control {ctrl:.3e} (must exceed tol)"
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        out = flash_attention(qb, kb, vb, **kw)
        plain = flash_attention_plain(qb, kb, vb, **kw)
        errb = (out.float() - plain.float()).abs().max().item()
        bounds = flash_attention_flip_bounds(qb, kb, vb, **kw)
        tc = flash_tc_check(out, plain, vb, bounds)
        need(tc.ok, f"flash {label} bf16: worst element at {tc.ratio} of its "
             f"tensor-core bound, {tc.share} of elements differ (limit "
             f"{tc.limit})")
        dense64 = dense_ref64(qb, kb, vb, **kw)
        dense = (out.double() - dense64).abs().max().item()
        modelled = (bounds.modelled != plain).double().mean().item()
        # controls the tolerance must reject: p kept in float32 before PV
        # (v widened exactly), the exact softmax rounded to bf16, and p
        # rounded toward zero in one 16-row slice of each 128 q rows (the
        # rows of one consumer warp)
        warp = (torch.arange(sq, device=dev) % 128 < 16)[None, :, None]
        ctrls = {"p unrounded": flash_attention_plain(qb, kb, vb.float(),
                                                      **kw),
                 "float64 rounded": dense64.bfloat16(),
                 "one warp truncating p": torch.where(
                     warp, flash_attention_plain(qb, kb, vb, truncate_p=True,
                                                 **kw), plain)}
        ctrl_txt = []
        for name, c in ctrls.items():
            c_tc = flash_tc_check(c, plain, vb, bounds)
            need(not c_tc.ok, f"flash {label} bf16: the tensor-core "
                 f"tolerance does not reject the {name} control")
            ctrl_txt.append(f"{name} {c_tc.ratio:.3g} / {c_tc.share:.3e}")
        report(line + f"; bf16 vs kernel-order plain {errb:.3e}: "
               f"tensor-core tolerance worst element at {tc.ratio:.3f} of its "
               f"bound, {tc.share:.3e} of elements differ (limit "
               f"{tc.limit:.3e}: 2^-13 + {SHARE_ROOM:g} x the tensor-core "
               f"model's {modelled:.3e}); controls rejected (worst / share "
               f"differing): {', '.join(ctrl_txt)}; vs the float64 dense "
               f"softmax of the bf16 inputs {dense:.3e}")
        worst = max(worst, err32, errb)
        if i == 0:
            keep = dict(q=qb, k=kb, v=vb, causal=causal, window=window)
    torch.cuda.synchronize()
    keep["err"] = worst
    return keep


def check_prefill_sites(params, planned, dense, report):
    """Phase 9b: layer 0's six stack sites at M = B·S, as phase 3 holds
    them at decode: the block-sparse kernel under the prefill plan's blocks
    (bitwise against its all-live run) and the flex kernels under the
    prefill table's schedule with every stationarity, in bf16 and float32,
    dense and half-dead activations; a TF32 control; bf16 times.  Returns
    the worst error per kernel and, per kernel, its bf16 (ms, bound ms) at
    mlp.in beside ``torch.matmul``'s ms (key ``library``)."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import block_sparse_matmul_ref, matmul_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    attached = planned.plan.attach(params)
    stats = ("output", "weight", "input")
    worst = dict.fromkeys(("block_sparse",) + stats, 0.0)
    times = {}
    for e in planned.plan.entries.values():
        if e.site not in PREFILL_SITES:
            continue
        pw = attached
        for key in e.path:
            pw = pw[key]
        pw = pw.index(0)
        desc = dense.schedules.sites[e.site]
        sched = desc.schedule
        k, n = pw.w_kn.shape
        a_full = torch.randn((desc.m, k), generator=gen, device=dev)
        kb = torch.rand(-(-k // e.bk), generator=gen, device=dev) < 0.5
        a_half = a_full * kb.repeat_interleave(e.bk)[:k]
        for dtype in (torch.bfloat16, torch.float32):
            pwd = dataclasses.replace(pw, w=pw.w.to(dtype))
            w_kn = pwd.w_kn
            errs = dict.fromkeys(worst, 0.0)
            tol = 0.0
            for act, a32 in (("dense", a_full), ("half", a_half)):
                a = a32.to(dtype)
                tol_a = matmul_tol(a, w_kn)
                tol = max(tol, tol_a)
                what = f"prefill {e.site} {dtype} {act}"
                xp, wp, meta, _ = planned_operands(a, pwd)
                out = bs.block_sparse_matmul(xp, wp, meta,
                                             out_dtype=torch.float32)
                err = (out - block_sparse_matmul_ref(xp, wp, meta)) \
                    .abs().max().item()
                need(err <= tol_a, f"block_sparse {what}: error {err} > "
                     f"{tol_a}")
                need(torch.equal(out, bs.block_sparse_matmul(
                    xp, wp, all_live(meta), out_dtype=torch.float32)),
                    f"block_sparse {what}: sparse != all-live run")
                errs["block_sparse"] = max(errs["block_sparse"], err)
                plain = matmul_ref(a, w_kn)
                outs = {}
                for stat in stats:
                    s = dataclasses.replace(sched, stationarity=stat)
                    outs[stat] = fm.flex_matmul(a, w_kn, schedule=s,
                                                out_dtype=torch.float32)
                    err = (outs[stat] - plain).abs().max().item()
                    need(err <= tol_a, f"flex_{stat} {what}: error {err} > "
                         f"{tol_a}")
                    errs[stat] = max(errs[stat], err)
                need(dtype is torch.float32 or torch.equal(
                    outs["input"], outs["weight"]),
                    f"flex_input {what}: differs from flex_weight")
                del outs
            line = (f"prefill {e.site} {str(dtype)[6:]} M={desc.m} K={k} "
                    f"N={n}: block_sparse ({e.bm},{e.bk},{e.bn}) "
                    f"{errs['block_sparse']:.3e}, flex ({sched.bm},"
                    f"{sched.bn},{sched.bk}, selected {sched.stationarity}) "
                    f"output/weight/input {errs['output']:.3e}/"
                    f"{errs['weight']:.3e}/{errs['input']:.3e}; tol "
                    f"{tol:.3e}; sparse == all-live bitwise")
            if dtype is torch.bfloat16:
                line += "; input == weight bitwise"
            if dtype is torch.float32:
                plain = matmul_ref(a_full, w_kn)
                ctrl = (matmul_ref(tf32(a_full), tf32(w_kn)) - plain) \
                    .abs().max().item()
                need(ctrl > matmul_tol(a_full, w_kn),
                     f"prefill {e.site}: the float32 tolerance does not "
                     f"reject TF32 operands ({ctrl})")
                line += f"; TF32 control {ctrl:.3e} (must exceed tol)"
            report(line)
            for key in worst:
                worst[key] = max(worst[key], errs[key])
        # bf16 times, activation dense as on the path
        a, w_kn = a_full.to(torch.bfloat16), pw.w_kn
        m = a.shape[0]
        xp, wp, meta, _ = planned_operands(a, pw)
        b_bs, by_bs = bs_bound_ms(xp, meta, (e.bm, e.bk, e.bn))
        b_fm, by_fm = bound_ms(a.numel() * 2 + w_kn.numel() * 2 + m * n * 4,
                               2.0 * m * n * k)
        t_bs = cuda_ms(lambda: bs.block_sparse_matmul(
            xp, wp, meta, out_dtype=torch.float32), iters=5)
        t_fm = {stat: cuda_ms(lambda: fm.flex_matmul(
            a, w_kn, schedule=dataclasses.replace(sched, stationarity=stat),
            out_dtype=torch.float32), iters=5) for stat in stats}
        t_plain = cuda_ms(lambda: matmul_ref(a, w_kn), iters=5)
        t_lib = cuda_ms(lambda: torch.matmul(a, w_kn), iters=5)
        is_rows = fm.revisit_rows(m)
        is_df = is_dataflow_ms(m, n, k, sched.bk, is_rows)
        is_df128 = is_dataflow_ms(m, n, k, sched.bk, 128)
        report(f"  prefill {e.site} bf16 ms: block_sparse {t_bs:.4f} (bound "
               f"{b_bs:.4f}, {by_bs}), flex output/weight/input "
               f"{t_fm['output']:.4f}/{t_fm['weight']:.4f}/"
               f"{t_fm['input']:.4f} (bound {b_fm:.4f}, {by_fm}; "
               f"weight- / input-stationary dataflow bounds "
               f"{ws_dataflow_ms(m, n, k, sched.bk):.4f} / {is_df:.4f} at "
               f"{is_rows} rows, {is_df128:.4f} at 128), "
               f"plain {t_plain:.4f}, torch.matmul {t_lib:.4f}")
        if e.site == "mlp.in":
            times = {"block_sparse": (t_bs, b_bs), "library": t_lib,
                     **{stat: (t_fm[stat], b_fm) for stat in stats},
                     "dataflow": {"weight": ws_dataflow_ms(m, n, k, sched.bk),
                                  "input": is_df, "input_rows": is_rows,
                                  "input_128": is_df128}}
    need(bool(times), "no mlp.in site in the prefill plan")
    torch.cuda.synchronize()
    return worst, times


def _timed(fn):
    """(fn(), wall seconds), synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _under(ec, fn):
    """``fn()`` under the ExecConfig ``ec`` (None: the plain path)."""
    import torch
    from repro_torch.kernels import ops
    with torch.no_grad():
        if ec is None:
            return fn()
        with ops.exec_config(ec):
            return fn()


def profile_prefill(fn, report, label) -> None:
    """One prefill under ``torch.profiler``: device-busy share of the wall
    time and its breakdown by kernel family.  A measurement only — a
    profiler that records nothing is reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _timed(fn)
    busy, n_kernels, fam = device_breakdown(prof)
    if not busy:
        report(f"profiled {label}: the profiler recorded no device time "
               "(not measured)")
        return
    report(f"profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
           f"{busy / 1e3:.1f} ms ({100 * busy / 1e3 / (wall * 1e3):.1f}% of "
           f"wall, {n_kernels} kernels); device ms and launches by kernel: "
           f"{fam}")


def run_prefill(cfg, params, dense, planned, shape, report) -> dict:
    """Phase 10, under the dense prefill table ``dense`` and the planned
    prefill config ``planned`` (both with ``use_kernels``).  Returns the
    flash kernel's launches (per prefill, and over the phase's prefills)
    and the tokens for phase 11."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import decode_exec_config

    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(b, s)), device="cuda")}
    max_seq = s + 16
    attached = planned.plan.attach(params)

    def prefill(ec, p):
        return _under(ec, lambda: model_lib.prefill(p, cfg, batch))

    # 1. the dense prefill table: fm kernels and the flash kernel
    reset_launches()
    logits, wall = _timed(lambda: prefill(dense, params))
    counts = launch_counts()
    report(f"bf16 prefill, dense table: {wall:.3f} s for {b} x {s} tokens = "
           f"{1e3 * wall / (b * s):.4f} ms per prompt token; launches "
           f"{counts}")
    need(counts["flash_attention"] == cfg.n_layers,
         f"flash kernel launched {counts['flash_attention']} times in one "
         f"prefill, not {cfg.n_layers}")
    need(counts["output"] > 0, "no flex kernel launch in the dense prefill")
    need(bool(torch.isfinite(logits).all()) and logits.shape ==
         (b, 1, cfg.vocab), "bad prefill logits")
    per_prefill = counts["flash_attention"]
    total = per_prefill
    tol = 0.05 * logits.abs().max().item()

    # 1b. the same table with every site forced weight-stationary: the
    # tensor-core fm_weight at every stack site (M = 8192) and the lm_head
    reset_launches()
    logits_w, wall = _timed(lambda: prefill(forced(dense, "weight"), params))
    counts = launch_counts()
    total += counts["flash_attention"]
    diff = (logits_w - logits).abs().max().item()
    report(f"bf16 prefill, dense table, all sites weight-stationary: "
           f"{wall:.3f} s = {1e3 * wall / (b * s):.4f} ms per prompt token; "
           f"fm_weight launches {counts['weight']}; launches {counts}; "
           f"logits vs dense table max |diff| = {diff:.3e}, tol {tol:.3e}")
    need(counts["weight"] > 0 and counts["output"] == 0,
         "the weight-stationary prefill did not run fm_weight alone")
    need(bool(torch.isfinite(logits_w).all()), "non-finite logits")
    need(diff <= tol, f"weight-stationary prefill logits off by {diff}")
    ws_launches = counts["weight"]

    # 1c. every site forced input-stationary: the tensor-core fm_input at
    # every site, its logits equal to the weight-stationary ones bit for bit
    reset_launches()
    logits_i, wall = _timed(lambda: prefill(forced(dense, "input"), params))
    counts = launch_counts()
    total += counts["flash_attention"]
    same = torch.equal(logits_i, logits_w)
    report(f"bf16 prefill, dense table, all sites input-stationary: "
           f"{wall:.3f} s = {1e3 * wall / (b * s):.4f} ms per prompt token; "
           f"fm_input launches {counts['input']}; launches {counts}; "
           f"logits == all sites weight-stationary bit for bit: {same}")
    need(counts["input"] > 0 and counts["output"] == 0,
         "the input-stationary prefill did not run fm_input alone")
    need(same, "input-stationary prefill logits differ from the "
         "weight-stationary ones")
    is_launches = counts["input"]
    del logits_i

    # 2. the planned two-sided plan at the prefill shape
    reset_launches()
    logits_p, wall = _timed(lambda: prefill(planned, attached))
    counts = launch_counts()
    total += counts["flash_attention"]
    diff = (logits_p - logits).abs().max().item()
    report(f"bf16 prefill, planned (skip fraction "
           f"{planned.plan.block_skip_fraction():.4f}): {wall:.3f} s; "
           f"launches {counts}; logits vs dense table max |diff| = "
           f"{diff:.3e} (must be 0)")
    need(counts["block_sparse"] > 0, "no block-sparse launch in the planned "
         "prefill")
    need(torch.equal(logits_p, logits), "planned prefill logits differ from "
         "the dense table's")

    # 3. the plain prefill
    logits_0, wall = _timed(lambda: prefill(None, params))
    diff = (logits_0 - logits).abs().max().item()
    report(f"bf16 prefill, plain (torch.matmul, plain online softmax): "
           f"{wall:.3f} s; logits vs dense table max |diff| = {diff:.3e}, "
           f"tol {tol:.3e}")
    need(diff <= tol, f"plain prefill logits off by {diff}")

    # 4. prefill_with_cache, and 16 greedy decode steps from its state
    reset_launches()
    (logits_c, state_c), wall = _timed(lambda: _under(
        dense, lambda: model_lib.prefill_with_cache(params, cfg, batch,
                                                    max_seq)))
    total += launch_counts()["flash_attention"]
    report(f"bf16 prefill_with_cache, dense table: {wall:.3f} s; logits == "
           f"prefill: {torch.equal(logits_c, logits)}")
    need(torch.equal(logits_c, logits), "prefill_with_cache logits differ "
         "from prefill's")
    logits_pc, state_pc = _under(None, lambda: model_lib.prefill_with_cache(
        params, cfg, batch, max_seq))
    for name in ("k", "v"):
        c, pc = state_c["layers"][name], state_pc["layers"][name]
        diff = (c.float() - pc.float()).abs().max().item()
        bound = 0.05 * pc.float().abs().max().item()
        report(f"  cache {name} vs the plain prefill's: max |diff| "
               f"{diff:.3e} (layer 0: "
               f"{(c[0].float() - pc[0].float()).abs().max().item():.3e}), "
               f"bound {bound:.3e} (5% of max |cache|: bf16 roundings "
               f"compound through the layers, as in the logits)")
        need(diff <= bound, f"cache {name} off by {diff}")
        need(not c[:, :, s:].any(), f"cache {name} written past the prompt")
    dec = decode_exec_config(cfg, b, use_kernels=True, device="cuda")
    first = logits[:, 0].argmax(-1)
    pos = torch.full((b,), s, dtype=torch.long, device="cuda")
    live = torch.ones((b,), dtype=torch.bool, device="cuda")

    def step_logits(state):
        st = {"layers": {n: t.clone() for n, t in state["layers"].items()}}
        return _under(dec, lambda: model_lib.decode_step(
            params, cfg, first[:, None], st, pos)[0])

    l1, l1p = step_logits(state_c), step_logits(state_pc)
    tol = 0.05 * l1.abs().max().item()
    diff = (l1 - l1p).abs().max().item()
    (toks, *_), wall = _timed(lambda: _under(
        dec, lambda: model_lib.decode_many(params, cfg, first, state_c, pos,
                                           live, 16)))
    toks_p = _under(dec, lambda: model_lib.decode_many(
        params, cfg, first, state_pc, pos, live, 16))[0]
    agree = int((toks == toks_p).sum())
    report(f"decode from the prefilled state (decode table, {b} slots, "
           f"max_seq {max_seq}): 16 steps in {wall:.3f} s; first-step logits "
           f"vs the plain-prefilled state's max |diff| {diff:.3e}, tol "
           f"{tol:.3e}; greedy tokens equal at {agree}/{toks.numel()}")
    need(diff <= tol, f"continuation logits off by {diff}")
    need(bool((toks >= 0).all()), "decode_many stopped a live row")

    # 5. one profiled prefill on the dense table, one on the plan
    profile_prefill(lambda: prefill(dense, params), report,
                    "bf16 prefill (dense table)")
    profile_prefill(lambda: prefill(planned, attached), report,
                    "bf16 prefill (planned)")
    return {"per_prefill": per_prefill, "total": total, "batch": batch,
            "ws_prefill": ws_launches, "is_prefill": is_launches}


def run_int8_prefill(cfg, sp_cfg, params, shape, batch, report):
    """Phase 11.  Returns the flash kernel's launches over its prefills,
    the int8 kernels' bf16 (ms, bound ms) at prefill mlp.in (layer 0's
    weight, a seeded activation) beside ``torch.matmul``'s ms on the
    dequantized bf16 weight (key ``bf16_matmul``), and the int8 kernels'
    worst errors over layer 0's six stack sites at M = B·S."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import ops
    from repro_torch.kernels.int8_matmul import int8_matmul
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.models import model as model_lib
    from repro_torch.quant.quantize import QuantizedLinear, quantize_params
    from repro_torch.serve.engine import shape_exec_config

    qparams, _ = quantize_params(params, tie_embeddings=cfg.tie_embeddings)
    dense8 = shape_exec_config(cfg, shape, use_kernels=True, quantize=True,
                               device="cuda")
    planned8 = shape_exec_config(sp_cfg, shape, use_kernels=True,
                                 params=params, quantize=True, device="cuda")
    attached = planned8.plan.attach(qparams)

    def prefill(ec, p):
        return _under(ec, lambda: model_lib.prefill(p, cfg, batch))

    total = 0
    reset_launches()
    logits, wall = _timed(lambda: prefill(dense8, qparams))
    counts = launch_counts()
    total += counts["flash_attention"]
    report(f"int8 prefill, dense int8 table: {wall:.3f} s; launches {counts}")
    need(counts["int8_matmul"] > 0 and counts["flash_attention"] ==
         cfg.n_layers, "the dense int8 prefill missed a kernel")
    reset_launches()
    logits_p, wall = _timed(lambda: prefill(planned8, attached))
    counts = launch_counts()
    total += counts["flash_attention"]
    diff = (logits_p - logits).abs().max().item()
    report(f"int8 prefill, planned (skip fraction "
           f"{planned8.plan.block_skip_fraction():.4f}): {wall:.3f} s; "
           f"launches {counts}; logits vs dense int8 table max |diff| = "
           f"{diff:.3e} (must be 0)")
    need(counts["block_sparse_scaled"] > 0, "no scaled block-sparse launch "
         "in the planned int8 prefill")
    need(torch.equal(logits_p, logits), "planned int8 prefill logits differ "
         "from the dense int8 table's")
    tol = 0.05 * logits.abs().max().item()
    logits_0, wall = _timed(lambda: prefill(ops.ExecConfig(quantize=True),
                                            qparams))
    diff = (logits_0 - logits).abs().max().item()
    report(f"int8 prefill, plain (bf16 dequantized, torch.matmul): "
           f"{wall:.3f} s; logits vs dense int8 table max |diff| = "
           f"{diff:.3e}, tol {tol:.3e}")
    need(diff <= tol, f"plain int8 prefill logits off by {diff}")

    # layer 0's six stack sites at M = B·S, as phase 6 holds them at
    # decode and phase 9 holds the bf16 kernels at this shape
    saved = launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst = dict.fromkeys(INT8_KERNELS, 0.0)
    times = {}
    for e in planned8.plan.entries.values():
        if e.site not in PREFILL_SITES:
            continue
        pw = attached
        for key in e.path:
            pw = pw[key]
        pw = pw.index(0)
        m = planned8.schedules.sites[e.site].m
        errs, a_full = check_int8_site(pw, e, m, gen, report, "int8 prefill")
        for key in worst:
            worst[key] = max(worst[key], errs[key])
        if e.site != "mlp.in":
            continue
        # the int8 kernels' times at mlp.in, as phase 9 times the bf16 ones
        k, n = pw.kn.shape
        a = a_full.to(torch.bfloat16)
        xp, wp, meta, scale = planned_operands(a, pw)
        qw = QuantizedLinear(pw.w, pw.qscale)
        w_bf16 = pw.w_kn.to(torch.bfloat16)
        b_bs, _ = bs_bound_ms(xp, meta, (e.bm, e.bk, e.bn), w_elem=1,
                              scale_elem=4)
        b_i8, _ = bound_ms(a.numel() * 2 + k * n + 4 * n + m * n * 4,
                           2.0 * m * n * k)
        times = {
            "block_sparse_scaled": (cuda_ms(lambda: bs.block_sparse_matmul(
                xp, wp, meta, scale=scale, out_dtype=torch.float32, rows=m),
                iters=5), b_bs),
            "int8_matmul": (cuda_ms(lambda: int8_matmul(
                a, qw, out_dtype=torch.float32), iters=5), b_i8),
            "bf16_matmul": cuda_ms(lambda: torch.matmul(a, w_bf16),
                                   iters=5)}
        report(f"  int8 prefill mlp.in M={m} K={k} N={n} bf16 ms: "
               f"block_sparse_scaled {times['block_sparse_scaled'][0]:.4f} "
               f"(bound {b_bs:.4f}), int8_matmul "
               f"{times['int8_matmul'][0]:.4f} (bound {b_i8:.4f}), bf16 "
               f"torch.matmul on the dequantized weight "
               f"{times['bf16_matmul']:.4f}")
    reset_launches(saved)
    need(bool(times), "no mlp.in site in the int8 prefill plan")
    report(f"int8 prefill-shape worst errors: {worst}")
    torch.cuda.synchronize()
    return total, times, worst


def flash_pairs(bh, sq, skv, causal, window) -> int:
    """The (q, k) pairs the mask keeps: query i sits at position i + skv -
    sq and sees keys up to it (causal) and fewer than ``window`` back."""
    import numpy as np
    pos = np.arange(sq) + (skv - sq)
    hi = pos + 1 if causal else np.full(sq, skv)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(sq, int)
    return bh * int((hi - lo).sum())


def time_flash(t, launches, name="flash_attention") -> dict:
    """A flash kernel's row of the ``kernels`` line: bf16 on the cell's
    operands ``t`` (phase 9: BH 64, S 4096, hd 64, causal; phases 16-17
    the hd-256 prefill cells)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_plain

    q, k, v = t["q"], t["k"], t["v"]
    kw = dict(causal=t["causal"], window=t["window"])
    bh, sq, hd = q.shape
    skv = k.shape[1]
    saved = launch_counts()
    pairs = flash_pairs(bh, sq, skv, **kw)
    b_ms, b_by = bound_ms(2 * (q.numel() + k.numel()) * q.element_size(),
                          4.0 * hd * pairs)

    def call():
        return flash_attention(q, k, v, **kw)

    # PyTorch's fused attention takes (1, BH, S, hd); a window is a mask
    if kw["window"]:
        pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = (pos - kpos < kw["window"]) & (pos >= kpos if kw["causal"]
                                              else True)

        def library():
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  attn_mask=mask)
    else:
        def library():
            return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                  is_causal=kw["causal"])
    try:
        lib_ms, lib_dev = cuda_ms(library, iters=10), device_ms(library,
                                                                calls=10)
    except RuntimeError as err:      # a yardstick only: none may take it
        print(f"{name}: scaled_dot_product_attention refused "
              f"({str(err)[:160]})", file=sys.stderr)
        lib_ms = lib_dev = None
    row = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": launches["per_prefill"],
        "launches_per_prefill": launches["per_prefill"],
        "launches_run": launches["total"],
        "max_abs_err": t["err"],
        "ms": cuda_ms(call, iters=10),
        "plain_ms": cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                            iters=3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms,
        "device_ms": device_ms(call, calls=10),
        "library_device_ms": lib_dev,
        "head_dim": hd, "bh": bh, "seq": sq, **kw}
    reset_launches(saved)
    return row


# ---------------------------------------------------------------------------
# phase 13: the full engine — sampling, chunked admission, async dispatch,
# lifecycle, NaN quarantine, density feedback, warmup
# ---------------------------------------------------------------------------

P13_NEW = 12          # new tokens per request
P13_BLOCK = 4         # decode_block: a request decodes over >= 3 blocks


def p13_traffic(cfg):
    """6 requests, prompts of 8-16 tokens: 3 greedy and 3 sampled
    (temperature 0.8, top_k 40, seeds 1-3), interleaved."""
    import numpy as np
    from repro_torch.serve.engine import SamplingParams
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 17)))
               for _ in range(6)]
    sampling = [None if i % 2 == 0 else SamplingParams(0.8, 40, i // 2 + 1)
                for i in range(6)]
    return list(zip(prompts, sampling))


def p13_engine(cfg, params, exec_cfg, **kw):
    import torch
    from repro_torch.serve.engine import ServeEngine
    kw.setdefault("prefill_chunk", 8)
    return ServeEngine(cfg, params, n_slots=N_SLOTS, max_seq=96,
                       dtype=torch.bfloat16, exec_cfg=exec_cfg,
                       decode_block=P13_BLOCK, device="cuda", **kw)


def p13_serve(eng, traffic, poison=False, max_new=P13_NEW):
    """Submit ``traffic`` (``max_new`` tokens each) two per tick through
    ``faults.drive`` to the end.
    With ``poison``, the first decoding request with 1-4 tokens credited
    (its later blocks still to come) has its slot poisoned.  Returns
    (streams, statuses, wall s, index of the poisoned request or None)."""
    import torch
    from repro_torch.serve.faults import drive, poison_slot_state
    uids, hit = [], []

    def on_tick(_):
        for p, sp in traffic[len(uids):len(uids) + 2]:
            uids.append(eng.submit(p, max_new=max_new, sampling=sp))
        if poison and not hit:
            for i in eng._live():
                r = eng.slots[i].req
                if 0 < len(r.out) <= P13_BLOCK:
                    poison_slot_state(eng, i)
                    hit.append(uids.index(r.uid))
                    break
        return len(uids) < len(traffic)

    torch.cuda.synchronize()
    t = time.perf_counter()
    drive(eng, on_tick=on_tick)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    res = eng.results()
    return ([res[u] for u in uids], [eng.status(u) for u in uids], wall,
            hit[0] if hit else None)


def check_sampling(report, card) -> None:
    """The port's threefry on the card against the CPU, V = 100352: random
    bits and uniforms bit for bit, Gumbel noise within one ulp of its
    magnitude plus 2^-23 (``torch.log`` on the two devices)."""
    import torch
    from repro_torch.models import prng
    v = 100352
    seeds = torch.tensor([1, 2, 3]).repeat_interleave(4)
    pos = torch.tensor([0, 1, 37, 2 ** 20]).repeat(3)
    out = {}
    for dev in ("cpu", "cuda"):
        key = prng.fold_in(prng.PRNGKey(seeds.to(dev)), pos.to(dev))
        out[dev] = [prng.random_bits(key, v).cpu(),
                    prng.uniform(key, v, minval=TINY32).cpu(),
                    prng.gumbel(key, v).cpu()]
    (b0, u0, g0), (b1, u1, g1) = out["cpu"], out["cuda"]
    need(torch.equal(b0, b1), "random bits on the card differ from the CPU")
    need(torch.equal(u0.view(torch.int32), u1.view(torch.int32)),
         "uniforms on the card differ from the CPU")
    ulp = torch.nextafter(g0.abs(), torch.tensor(float("inf"))) - g0.abs()
    diff = (g1 - g0).abs()
    need(bool(torch.isfinite(g1).all()), "non-finite Gumbel noise")
    need(bool((diff <= ulp + 2.0 ** -23).all()),
         f"Gumbel noise off by {diff.max().item():.3e}")
    big = g0.abs() >= 1
    report(f"sampling on the card, 3 seeds x 4 positions x V {v}: bits and "
           f"uniforms equal the CPU's bit for bit; Gumbel max |diff| "
           f"{diff.max().item():.3e}, worst {(diff / ulp)[big].max().item():.1f}"
           f" ulp of |g| where |g| >= 1, {(diff > 0).float().mean().item():.4f}"
           f" of elements differ ({card})")
    # what one decode step's sampling costs at (4 slots, V)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.model import sample_tokens
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    args = (torch.randn((N_SLOTS, v), generator=gen, device="cuda"),
            torch.full((N_SLOTS,), 0.8, device="cuda"),
            torch.full((N_SLOTS,), 40, device="cuda"),
            seeds[:N_SLOTS].cuda(), pos[:N_SLOTS].cuda())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sample_tokens(*args)
        torch.cuda.synchronize()
    _, n_kernels, _ = device_breakdown(prof)
    report(f"sample_tokens at ({N_SLOTS}, {v}): "
           f"{cuda_ms(lambda: sample_tokens(*args)):.3f} ms per call (CUDA "
           f"events, host-paced), device time "
           f"{device_ms(lambda: sample_tokens(*args))} ms, {n_kernels} "
           f"kernels; argmax alone "
           f"{cuda_ms(lambda: torch.argmax(args[0], dim=-1)):.3f} ms ({card})")


def p13_decode_rate(eng, traffic, report, card, label, sampled) -> float:
    """ms per decode step and tokens/s of 4 live requests (4-token prompts,
    24 new tokens) once all four stream: the blocks after every first
    token, ticked by ``decode_block_step`` to the end.  The caller runs it
    once first on the same engine, so its shapes are captured."""
    import torch
    from repro_torch.serve.engine import SamplingParams
    for i, (p, _) in enumerate(traffic[:N_SLOTS]):
        eng.submit(p[:4], max_new=24,
                   sampling=SamplingParams(0.8, 40, i + 1) if sampled
                   else None)
    while len(eng._live()) < N_SLOTS or any(
            not eng.slots[i].req.out for i in eng._live()):
        eng.decode_block_step()
    eng.flush()
    torch.cuda.synchronize()
    n0 = sum(len(s.req.out) for s in eng.slots)
    t = time.perf_counter()
    while not eng._drained():
        eng.decode_block_step()
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n_tok = sum(len(s.req.out) for s in eng.slots) - n0
    need(n_tok == N_SLOTS * 24 - n0, f"{label}: lost tokens")
    ms = 1e3 * wall / (n_tok / N_SLOTS)
    report(f"  {label}: {ms:.2f} ms per decode step, "
           f"{n_tok / wall:.1f} tokens/s ({n_tok} tokens in {wall:.3f} s; "
           f"{card})")
    return ms


# the warning ``set_sync_debug_mode("warn")`` gives for each synchronizing
# call; its other warning, once a process, says the mode is a prototype
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn, sites=None) -> int:
    """Synchronizing CUDA calls made by ``fn()``, counted from the
    warnings of ``torch.cuda.set_sync_debug_mode("warn")`` (``SYNC_WARNING``
    only: the mode's own first warning, which also names synchronization,
    is not a call).  With a ``sites`` list,
    the Python frames that made each call are appended to it (a warning is
    raised in the calling thread, so the stack at that moment names the
    line)."""
    import traceback
    import warnings
    import torch
    torch.cuda.synchronize()
    seen = []
    shown = warnings.showwarning

    def show(message, *args, **kw):
        if SYNC_WARNING in str(message):
            seen.append(" <- ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(traceback.extract_stack()[-9:-1])
                if f.filename != warnings.__file__))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    if sites is not None:
        sites.extend(seen)
    return len(seen)


def p13_lifecycle(cfg, params, traffic, report) -> None:
    """Host logic under a ``VirtualClock`` at 2 layers (dense table, 2
    slots, max_queue 2): one cancel in mid-decode, one missed deadline,
    one request shed."""
    import torch
    from repro_torch.core.sparsity import map_leaves
    from repro_torch.serve.engine import ServeEngine, decode_exec_config
    from repro_torch.serve.faults import VirtualClock, drive
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    params2 = map_leaves(lambda path, leaf: leaf[:2]
                         if path[:2] == ("stack", "layers") else leaf, params)
    clk = VirtualClock()
    eng = ServeEngine(cfg2, params2, n_slots=2, max_seq=96,
                      dtype=torch.bfloat16,
                      exec_cfg=decode_exec_config(cfg2, 2, use_kernels=True,
                                                  device="cuda"),
                      decode_block=P13_BLOCK, prefill_chunk=8, max_queue=2,
                      clock=clk, device="cuda")
    p = [t[0] for t in traffic]
    u1 = eng.submit(p[0], max_new=40)
    u2 = eng.submit(p[1], max_new=40, sampling=traffic[1][1], deadline=50.0)
    eng.decode_block_step()
    u3, u4, u5 = (eng.submit(q, max_new=6) for q in p[2:5])
    need(eng.status(u5) == "shed", "a full queue did not shed")
    eng.decode_block_step()
    eng.decode_block_step()
    need(eng.status(u1) == "decode", f"request 1 is {eng.status(u1)}")
    need(eng.cancel(u1) and not eng.cancel(u1), "cancel in mid-decode")
    clk.advance(100.0)
    drive(eng)
    got = [eng.status(u) for u in (u1, u2, u3, u4, u5)]
    res = eng.results()
    want = ["cancelled", "deadline_missed", "done", "done", "shed"]
    counters = {"done": 2, "cancelled": 1, "deadline_missed": 1,
                "failed": 0, "shed": 1, "demotions": 0}
    report(f"lifecycle (2 layers, VirtualClock): statuses {got}, counters "
           f"{eng.counters}, tokens {[len(res[u]) for u in (u1, u2, u3, u4)]}")
    need(got == want, f"lifecycle statuses {got}, expected {want}")
    need(eng.counters == counters, f"counters {eng.counters}")
    need(len(res[u3]) == len(res[u4]) == 6 and 0 < len(res[u1]) < 40,
         "lifecycle streams")


def run_full_engine(cfg, params, planned, dense, report, card) -> dict:
    """Phase 13.  Returns the launches of its main path (runs A-E)."""
    import torch
    t_phase = time.perf_counter()
    traffic = p13_traffic(cfg)
    check_sampling(report, card)
    stats_ec = dataclasses.replace(planned, collect_stats=True)

    reset_launches()
    runs = {}
    for label, ec, kw in (
            ("A planned, async, chunked, collect_stats", stats_ec, {}),
            ("B planned, sync, whole prompt", planned,
             {"async_dispatch": False, "prefill_chunk": None}),
            ("D dense table, async, chunked", dense, {})):
        eng = p13_engine(cfg, params, ec, **kw)
        streams, statuses, wall, _ = p13_serve(eng, traffic)
        n_tok = sum(len(x) for x in streams)
        report(f"  run {label}: {n_tok} tokens in {wall:.2f} s = "
               f"{n_tok / wall:.1f} tokens/s ({card})")
        need(statuses == ["done"] * 6 and all(
            len(x) == P13_NEW for x in streams), f"run {label}: {statuses}")
        runs[label[0]] = (eng, streams)
    oracle = p13_engine(cfg, params, planned, fused=False)
    ouids = [oracle.submit(p, max_new=P13_NEW, sampling=sp)
             for p, sp in traffic]
    ores = oracle.run_until_drained()
    streams_a = runs["A"][1]
    # the first N_SLOTS requests (a stream does not depend on its
    # batchmates)
    eager = eager_entries(p13_engine(cfg, params, stats_ec))
    streams_e, _, wall_e, _ = p13_serve(eager, traffic[:N_SLOTS])
    report(f"  run A's configuration on the eager entry points, its first "
           f"{N_SLOTS} requests: {wall_e:.2f} s")
    del eager
    same = {"B (sync, whole)": runs["B"][1] == streams_a,
            "C (step() oracle)": [ores[u] for u in ouids] == streams_a,
            "D (dense table)": runs["D"][1] == streams_a,
            "A on the eager entry points":
                streams_e == streams_a[:N_SLOTS]}
    report(f"streams of run A (planned, async, chunked) equal: {same}")
    for what, ok in same.items():
        need(ok, f"phase 13: run A's streams differ from {what}")

    # quarantine on the dense table (a two-sided bitmap reads a NaN block
    # as dead, as the reference's does, and would hide the poison)
    eng = p13_engine(cfg, params, dense)
    streams, statuses, _, hit = p13_serve(eng, traffic, poison=True)
    need(hit is not None, "phase 13: no request was poisoned")
    others_same = all(streams[i] == streams_a[i] for i in range(6)
                      if i != hit)
    report(f"quarantine: request {hit} poisoned -> {statuses[hit]} after "
           f"{len(streams[hit])} of {P13_NEW} tokens (its clean stream's "
           f"prefix: {streams[hit] == streams_a[hit][:len(streams[hit])]}); "
           f"other streams equal the unpoisoned run's: {others_same}")
    need(statuses[hit] == "failed" and eng.counters["failed"] == 1,
         "the poisoned request did not fail")
    need(len(streams[hit]) < P13_NEW
         and streams[hit] == streams_a[hit][:len(streams[hit])],
         "the poisoned stream is not a clean prefix")
    need(others_same and statuses.count("done") == 5,
         "the poison reached another stream")
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in ("block_sparse", "block_sparse_sum",
                                       "output", "output_sum")}
    report(f"main-path launches (phase 13, runs A-E): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched in phase 13")

    # density feedback: every planned two-sided site measured, in (0, 1]
    dens = runs["A"][0].activation_densities()
    sites = {e.site for e in planned.plan.entries.values()
             if e.mode == "two_sided"}
    report(f"activation densities (run A): "
           f"{ {k: round(v, 6) for k, v in sorted(dens.items())} }")
    need(set(dens) == sites and all(0.0 < v <= 1.0 for v in dens.values()),
         f"densities {dens} for planned sites {sorted(sites)}")

    # one decode block launched from the carries and read, with and
    # without popcounts: the stats add no synchronizing call
    syncs = {}
    for label, ec in (("without stats", planned), ("with stats", stats_ec)):
        eng = p13_engine(cfg, params, ec, async_dispatch=False)
        for p, _ in traffic[:N_SLOTS]:
            eng.submit(p[:2], max_new=16)
        eng.decode_block_step()
        live = eng._live()
        need(len(live) == N_SLOTS, "sync count: not every slot decodes")

        def block():
            eng._launch(live, P13_BLOCK)
            eng._account_one()
        syncs[label] = count_syncs(block)
        if label == "without stats":
            # warmup mid-traffic: every state bit stays as it was
            eng.flush()
            before = {k: v.clone() for k, v in eng.state["layers"].items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.warmup()
            warm_s = time.perf_counter() - t
            same_state = all(torch.equal(before[k].view(torch.int16),
                                         v.view(torch.int16))
                             for k, v in eng.state["layers"].items())
            report(f"warmup: {warm_s:.2f} s (kernels built; blocks of "
                   f"1-{P13_BLOCK}, feeds of 1-{P13_BLOCK} and the step "
                   f"captured, every row dead: {graph_stats(eng)}), state "
                   f"bit-unchanged: {same_state} ({card})")
            need(same_state, "warmup changed the decode state")
    report(f"synchronizing calls in one replayed decode block: {syncs}")
    need(syncs["with stats"] == syncs["without stats"] == 0,
         "a replayed decode block made a synchronizing call")

    # host-paced times spread from run to run: each mode twice, in turns
    report("decode rate, 4 live requests (planned; one engine a mode, its "
           "shapes captured by a first, unreported run):")
    ms = {"greedy, async": [], "sampled, async": [], "greedy, sync": []}
    engines = {}
    for label in ("greedy, async", "sampled, async", "greedy, sync",
                  "greedy, sync", "sampled, async", "greedy, async"):
        sampled = label.startswith("sampled")
        if label not in engines:
            engines[label] = p13_engine(
                cfg, params, planned, async_dispatch=label.endswith("async"))
            p13_decode_rate(engines[label], traffic, lambda _: None, card,
                            label, sampled)
        ms[label].append(p13_decode_rate(engines[label], traffic, report,
                                         card, label, sampled))
    del engines
    free()
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    report(f"  means: {({k: round(v, 2) for k, v in mean.items()})} ms; "
           f"async / sync {mean['greedy, async'] / mean['greedy, sync']:.3f}"
           f", sampled / greedy "
           f"{mean['sampled, async'] / mean['greedy, async']:.3f}")
    p13_lifecycle(cfg, params, traffic, report)
    report(f"phase 13 wall time: {time.perf_counter() - t_phase:.1f} s "
           f"({card})")
    return launches

# ---------------------------------------------------------------------------
# phase 14: plan tiers and self-speculative decoding
# ---------------------------------------------------------------------------

P14_NEW = 16          # new tokens per request
P14_K = 4             # drafts per verify block: windows of 5, M = 4 * 5 = 20
P14_TIERS = (0.0, 0.5)


def p14_engine(cfg, params, exec_cfg, **kw):
    """Phase 13's engine with the plan tiers (0.0, 0.5) unless given."""
    kw.setdefault("plan_tiers", P14_TIERS)
    return p13_engine(cfg, params, exec_cfg, **kw)


def p14_oracle(cfg, params, exec_cfg, traffic, max_new, **kw):
    """The streams of the ``step()`` oracle over ``traffic``."""
    eng = p14_engine(cfg, params, exec_cfg, fused=False, **kw)
    uids = [eng.submit(p, max_new=max_new, sampling=sp) for p, sp in traffic]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


def p14_served(eng, traffic, label, max_new=P14_NEW):
    """Serve ``traffic`` as phase 13 does; every request must end done
    with ``max_new`` tokens.  Returns the streams."""
    streams, statuses, wall, _ = p13_serve(eng, traffic, max_new=max_new)
    need(statuses == ["done"] * len(traffic)
         and all(len(x) == max_new for x in streams),
         f"phase 14 {label}: {statuses}")
    return streams, wall


def tier_pruned(params, plan):
    """``params`` with every block that ``plan`` leaves out of its lists
    zeroed: at a pruned tier, the weight ``prune_k_blocks`` leaves at the
    tier's ratio (the dead blocks are zero already)."""
    import torch
    from repro_torch.core.sparsity import map_leaves, plannable_kn

    def prune(path, leaf):
        e = plan.entries.get("/".join(path))
        if e is None:
            return leaf
        kn = plannable_kn(leaf, e.site)
        p_, k, n = kn.shape
        keep = torch.as_tensor(e.b_bitmap, device=kn.device).reshape(
            p_, e.tk, e.tn)
        mask = keep.repeat_interleave(e.bk, 1).repeat_interleave(
            e.bn, 2)[:, :k, :n]
        out = torch.where(mask, kn, torch.zeros((), dtype=kn.dtype,
                                                device=kn.device))
        return out[0].t().contiguous() if e.transpose else out.reshape(
            leaf.shape)
    return map_leaves(prune, params)


def state_copy(eng):
    return {"layers": {n: t.clone() for n, t in eng.state["layers"].items()}}


def bits(t):
    """A bf16 tensor's bits (int16) or a float32 tensor's (int32)."""
    import torch
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def p14_window(cfg, params, wo, traffic, report, card) -> dict:
    """Gate 3 from a state captured mid-traffic (4 live greedy rows): one
    ``verify_block`` windowed and sequential, and one ``verify_window``
    against ``masked_decode_step`` at each position.  Then the profiles:
    a decode step on tier 0, a draft step on tier 1, a verify window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_lib
    eng = p14_engine(cfg, params, wo, speculate_k=P14_K)
    for p, _ in traffic[:N_SLOTS]:
        eng.submit(p, max_new=P14_NEW)
    while len(eng._live()) < N_SLOTS or any(
            not eng.slots[i].req.out for i in eng._live()):
        eng.decode_block_step()
    eng.flush()
    live = eng._live()
    toks = eng._to_device(eng._current_tokens(live))
    pos = eng._to_device(eng._slot_positions())
    mask = eng._live_mask(live)
    rem = eng._to_device(eng._slot_budgets(live))
    full, draft = eng._tier_params
    with eng._scope():
        out = {w: model_lib.verify_block(full, draft, cfg, toks,
                                         state_copy(eng), pos, mask, P14_K,
                                         rem=rem, windowed=w)
               for w in (True, False)}
        blk_w, st_w, *car_w = out[True]
        blk_s, st_s, *car_s = out[False]
        same_tokens = torch.equal(blk_w, blk_s) and all(
            torch.equal(a, b) for a, b in zip(car_w, car_s))
        # positions below each row's new position: the window also wrote
        # the rejected drafts' K/V above it, which no query reads
        below = (torch.arange(eng.max_seq, device="cuda")[None, :]
                 < car_w[1].long()[:, None])
        same_state = all(torch.equal(bits(st_w["layers"][n][:, below]),
                                     bits(st_s["layers"][n][:, below]))
                         for n in ("k", "v"))
        drafts, *_ = model_lib.decode_many(draft, cfg, toks, state_copy(eng),
                                           pos, mask, P14_K)
        win = torch.cat([toks[:, None], drafts.t().clamp_min(0).long()], 1)
        lw, st_win = model_lib.verify_window(full, cfg, win, state_copy(eng),
                                             pos, mask)
        st_step = state_copy(eng)
        worst, equal = 0.0, []
        for i in range(P14_K + 1):
            ls, st_step = model_lib.masked_decode_step(
                full, cfg, win[:, i:i + 1], st_step, pos + i, mask)
            equal.append(torch.equal(bits(ls[:, 0]), bits(lw[:, i])))
            worst = max(worst, (ls[:, 0] - lw[:, i]).abs().max().item())
        steps_state = all(torch.equal(bits(st_win["layers"][n]),
                                      bits(st_step["layers"][n]))
                          for n in ("k", "v"))
    accepted = (blk_w >= 0).sum(0).tolist()
    report(f"gate 3, one verify block from a captured state (k {P14_K}, "
           f"M {N_SLOTS * (P14_K + 1)}): tokens emitted per row {accepted}; "
           f"windowed == sequential: tokens and carries {same_tokens}, "
           f"state below each row's position {same_state}; verify_window "
           f"logits == masked_decode_step's at positions 0-{P14_K}: {equal}"
           f" (max |diff| {worst:.3e}), states {steps_state}")
    need(same_tokens, "gate 3: windowed and sequential verify blocks differ")
    need(same_state, "gate 3: windowed and sequential states differ")
    need(all(equal) and steps_state,
         "gate 3: window logits or state differ from the decode steps")
    # the engine's replayed verify block from the same state (phase 23)
    ex = eng._block_exec(0, P14_K + 1, False, P14_K)
    eng._run(ex, *eng._dead_rows(False))      # captured if it was not
    snap = state_copy(eng)
    before = launch_counts()
    got = eng._run(ex, toks, pos, mask, rem)
    credited = launch_counts()
    with eng._scope():
        model_lib.verify_block(full, draft, cfg, toks, state_copy(eng), pos,
                               mask, P14_K, rem=rem, windowed=True,
                               nan_guard=eng.nan_guard)
    counted = launch_counts()
    torch.cuda.synchronize()
    same_replay = (all(torch.equal(a, b) for a, b in zip(got, (blk_w,
                                                               *car_w)))
                   and all(torch.equal(bits(eng.state["layers"][n]),
                                       bits(st_w["layers"][n]))
                           for n in ("k", "v")))
    d_replay = {k: credited[k] - before[k] for k in before
                if credited[k] != before[k]}
    d_eager = {k: counted[k] - credited[k] for k in before
               if counted[k] != credited[k]}
    for n in ("k", "v"):
        eng.state["layers"][n].copy_(snap["layers"][n])
    report(f"phase 23: the replayed greedy verify block (k {P14_K}) == "
           f"model.verify_block windowed from the same state: tokens, "
           f"carries and state bit for bit {same_replay}; launches credited "
           f"{d_replay} == the eager call's {d_replay == d_eager}")
    need(same_replay, "phase 23: the replayed verify block differs")
    need(d_replay == d_eager and d_replay,
         "phase 23: the verify replay's launches differ from the eager ones")

    def profiled(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return device_breakdown(prof)

    prof = {}
    st = state_copy(eng)
    with eng._scope():
        for label, tier_p in (("decode step, tier 0", full),
                              ("draft step, tier 1", draft)):
            prof[label] = profiled(lambda: model_lib.decode_many(
                tier_p, cfg, toks, st, pos, mask, 1))
        prof["verify window, tier 0"] = profiled(
            lambda: model_lib.verify_window(full, cfg, win, st, pos, mask))
    listed = [sum(int(e.wkcnt.sum()) for e in plan.entries.values())
              for plan in eng.plan_tiers]
    for label, (busy, n_kernels, fam) in prof.items():
        bs_ms = fam.get("bs_matmul", (0.0, 0))
        report(f"profiled {label}: device busy {busy / 1e3:.3f} ms over "
               f"{n_kernels} kernels; bs_matmul {bs_ms[0]} ms in "
               f"{bs_ms[1]} launches (segment sums "
               f"{fam.get('segment sums', (0.0, 0))[0]} ms); {fam} ({card})"
               if busy else f"profiled {label}: no device time recorded "
               "(not measured)")
    report(f"listed K-blocks over all planned sites: tier 0 {listed[0]}, "
           f"tier 1 {listed[1]} ({listed[1] / listed[0]:.4f} of tier 0's)")
    return {k: v[0] / 1e3 for k, v in prof.items()}


def p14_tier_sites(params, tier, dense, report) -> None:
    """Gate 4, kernels: at layer 0's six stack sites, ``bs_matmul`` under
    the 0.5 tier's lists equals ``fm_output`` on the weight that
    ``prune_k_blocks`` prunes at ``tier_max_live(tk, 0.5)``, bit for bit,
    at M = 4 (decode) and M = 20 (a verify window); and that weight equals
    the stored one masked by the tier's bitmap."""
    import torch
    from repro_torch.core.sparsity import prune_k_blocks, tier_max_live
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ops import _planned_matmul
    attached = tier.attach(params, verify=False)
    masked = tier_pruned(params, tier)
    gen = torch.Generator(device="cuda").manual_seed(14)
    for parent, leaf in (("attn", "wq"), ("attn", "wkv"), ("attn", "wo"),
                         ("mlp", "w_in"), ("mlp", "w_gate"),
                         ("mlp", "w_out")):
        pw = attached["stack"]["layers"][parent][leaf].index(0)
        w = params["stack"]["layers"][parent][leaf][0]
        k = w.shape[0]
        cut = tier_max_live(-(-k // pw.bk), 0.5)
        wp = torch.from_numpy(prune_k_blocks(
            w.float().cpu().numpy(), pw.bk, pw.bn, cut)).to(
            "cuda", torch.bfloat16)
        # by value: prune_k_blocks multiplies by 0, leaving -0.0 in place of
        # negative values, where the mask leaves +0.0
        need(torch.equal(wp, masked["stack"]["layers"][parent][leaf][0]),
             f"gate 4: {pw.site}: the tier's mask is not prune_k_blocks'")
        sched = dataclasses.replace(dense.schedules.sites[pw.site].schedule,
                                    stationarity="output")
        for m in (N_SLOTS, N_SLOTS * (P14_K + 1)):
            x = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
            got = _planned_matmul(x, pw)
            want = fm.flex_matmul(x, wp, schedule=sched,
                                  out_dtype=torch.float32)
            need(torch.equal(bits(got), bits(want)),
                 f"gate 4: {pw.site} at M = {m}: bs_matmul under the tier "
                 f"differs from fm_output on the pruned weight by "
                 f"{(got - want).abs().max().item():.3e}")
        report(f"  gate 4 {pw.site}: K-blocks kept {cut} of "
               f"{-(-k // pw.bk)} (tier max_nnz {pw.max_nnz}); bs_matmul "
               f"(tier lists) == fm_output (pruned weight) bit for bit at "
               f"M = {N_SLOTS} and {N_SLOTS * (P14_K + 1)}")


def p14_host(cfg, wo_cfg, params, traffic, report) -> None:
    """Gate 6 at 2 layers (weight-only plan, tiers, speculation) under a
    ``VirtualClock`` that moves 1 s a tick: a request of 40 tokens due in
    5 s is demoted to class 1 once a service rate exists (two blocks
    read: tick 3), then misses its deadline; ``warmup`` leaves the state
    bit for bit."""
    import torch
    from repro_torch.core.sparsity import map_leaves
    from repro_torch.serve.engine import ServeEngine, decode_exec_config
    from repro_torch.serve.faults import VirtualClock
    cfg2 = dataclasses.replace(wo_cfg, n_layers=2)
    params2 = map_leaves(lambda path, leaf: leaf[:2]
                         if path[:2] == ("stack", "layers") else leaf, params)
    clk = VirtualClock()
    eng = ServeEngine(cfg2, params2, n_slots=2, max_seq=96,
                      dtype=torch.bfloat16,
                      exec_cfg=decode_exec_config(cfg2, 2, params=params2,
                                                  device="cuda"),
                      decode_block=P13_BLOCK, plan_tiers=P14_TIERS,
                      speculate_k=P14_K, clock=clk, device="cuda")
    u1 = eng.submit(traffic[0][0], max_new=40, deadline=5.0)
    u2 = eng.submit(traffic[1][0], max_new=8)
    r1 = eng.queue[0]
    for _ in range(40):
        eng.decode_block_step()
        clk.advance(1.0)
        if eng._drained() and not eng._inflight:
            break
    eng.flush()
    report(f"gate 6 (2 layers, VirtualClock): request 1 class "
           f"{r1.latency_class} after {r1.demotions} demotion(s), status "
           f"{eng.status(u1)}; request 2 {eng.status(u2)}; counters "
           f"{eng.counters}; spec {eng.spec_stats}")
    need(r1.latency_class == 1 and r1.demotions == 1
         and eng.counters["demotions"] == 1,
         "gate 6: the request under deadline pressure was not demoted")
    need(eng.status(u1) == "deadline_missed" and eng.status(u2) == "done",
         "gate 6: statuses")
    eng.submit(traffic[2][0], max_new=8)
    eng.decode_block_step()
    eng.flush()
    before = {k: v.clone() for k, v in eng.state["layers"].items()}
    eng.warmup()
    same = all(torch.equal(bits(before[k]), bits(v))
               for k, v in eng.state["layers"].items())
    report(f"gate 6: warmup with tiers and speculation leaves the state "
           f"bit for bit: {same}")
    need(same, "gate 6: warmup changed the decode state")


def p14_rate(eng, traffic, report, card, label):
    """ms per emitted token of 4 live requests (4-token prompts, 12 new
    tokens, greedy) once all four stream, ticked by ``decode_block_step``
    to the end.  The caller runs it once first on the same engine, so its
    shapes are captured.  Returns (ms per emitted token, acceptance of
    this run or None)."""
    import torch
    stats0 = dict(eng.spec_stats)
    for p, _ in traffic[:N_SLOTS]:
        eng.submit(p[:4], max_new=12)
    while len(eng._live()) < N_SLOTS or any(
            not eng.slots[i].req.out for i in eng._live()):
        eng.decode_block_step()
    eng.flush()
    torch.cuda.synchronize()
    n0 = sum(len(s.req.out) for s in eng.slots)
    t = time.perf_counter()
    while not eng._drained():
        eng.decode_block_step()
    eng.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n_tok = sum(len(s.req.out) for s in eng.slots) - n0
    need(n_tok == N_SLOTS * 12 - n0, f"{label}: lost tokens")
    drafted = eng.spec_stats["drafted"] - stats0["drafted"]
    acc = ((eng.spec_stats["accepted"] - stats0["accepted"]) / drafted
           if eng.speculate_k and drafted else None)
    ms = 1e3 * wall / n_tok
    report(f"  {label}: {ms:.3f} ms per emitted token ({n_tok} tokens in "
           f"{wall:.3f} s; {1e3 * wall / (n_tok / N_SLOTS):.2f} ms per "
           f"token of a stream; acceptance {acc}; {card})")
    return ms, acc


def run_speculative(cfg, params, planned, dense, traffic, report,
                    card) -> dict:
    """Phase 14.  Returns the launches of its run."""
    import torch
    from repro_torch.configs import SparsityConfig
    from repro_torch.serve.engine import decode_exec_config
    t_phase = time.perf_counter()
    reset_launches()
    wo_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.0))
    t0 = time.perf_counter()
    wo = decode_exec_config(wo_cfg, N_SLOTS, params=params, device="cuda")
    torch.cuda.synchronize()
    report(f"weight-only plan bring-up: {time.perf_counter() - t0:.1f} s")
    report(wo.schedules.describe())

    # gate 1: speculation is exact (k = 4: M = 20; k = 3: M = 16)
    t0 = time.perf_counter()
    s4 = p14_engine(cfg, params, wo, speculate_k=P14_K)
    report(f"tiered engine bring-up (tier 0.5 compiled and attached): "
           f"{time.perf_counter() - t0:.2f} s")
    streams4, wall4 = p14_served(s4, traffic, "k = 4")
    streams0, wall0 = p14_served(p14_engine(cfg, params, wo), traffic,
                                 "tiered, k = 0")
    oracle = p14_oracle(cfg, params, wo, traffic, P14_NEW)
    # k = 3 on the first 4 requests x 8 tokens: its streams are the first
    # 8 tokens of the others'
    s3 = p14_engine(cfg, params, wo, speculate_k=3)
    streams3, wall3 = p14_served(s3, traffic[:N_SLOTS], "k = 3", max_new=8)
    eager4, wall_e = p14_served(eager_entries(p14_engine(
        cfg, params, wo, speculate_k=P14_K)), traffic[:N_SLOTS],
        "k = 4, eager", max_new=8)
    same = {"k = 0": streams0 == streams4, "step() oracle": oracle == streams4,
            "k = 3": streams3 == [x[:8] for x in streams4[:N_SLOTS]],
            f"k = 4 on the eager entry points, the first {N_SLOTS} "
            f"requests x 8 ({wall_e:.2f} s)":
                eager4 == [x[:8] for x in streams4[:N_SLOTS]]}
    report(f"gate 1: streams of the speculative engine (k {P14_K}, windows "
           f"of M = {N_SLOTS * (P14_K + 1)}) equal: {same}; acceptance "
           f"k 4 {s4.speculative_acceptance():.4f} {s4.spec_stats}, k 3 "
           f"{s3.speculative_acceptance():.4f} {s3.spec_stats}; walls "
           f"k 4 {wall4:.2f} s, k 0 {wall0:.2f} s, k 3 {wall3:.2f} s "
           f"({card})")
    for what, ok in same.items():
        need(ok, f"gate 1: the speculative streams differ from {what}")
    need(s4.spec_stats["verify_blocks"] > 0
         and s3.spec_stats["verify_blocks"] > 0, "gate 1: no verify block")
    # the two-sided config gates speculation off, as the reference does
    two = p14_engine(planned.arch_cfg, params, planned, speculate_k=P14_K)
    p14_served(two, [(p[:1], sp) for p, sp in traffic[:N_SLOTS]],
               "two-sided", max_new=8)
    report(f"two-sided engine with speculate_k {P14_K}: _spec_windowed "
           f"{two._spec_windowed}, verify blocks "
           f"{two.spec_stats['verify_blocks']}")
    need(not two._spec_windowed and two.spec_stats["verify_blocks"] == 0,
         "the two-sided engine speculated")

    # gate 2: a self-drafting engine accepts every draft (15 = 3 windows
    # of 5 new tokens and no EOS, so no row stops inside a window)
    self_eng = p14_engine(cfg, params, wo, plan_tiers=None,
                          speculate_k=P14_K)
    streams_self, _ = p14_served(self_eng, traffic, "self-draft",
                                 max_new=15)
    acc = self_eng.speculative_acceptance()
    report(f"gate 2: self-draft (plan_tiers None, k {P14_K}) acceptance "
           f"{acc} {self_eng.spec_stats}; streams == the first 15 tokens of "
           f"gate 1's: {streams_self == [x[:15] for x in streams4]}")
    need(acc == 1.0, f"gate 2: self-draft acceptance {acc}, not 1.0")
    need(streams_self == [x[:15] for x in streams4],
         "gate 2: self-draft streams differ from gate 1's")

    # gate 3 and the profiles
    prof = p14_window(cfg, params, wo, traffic, report, card)

    # gate 4: a tier is the dense product of the tier-pruned weight
    tier = s4.plan_tiers[1]
    p14_tier_sites(params, tier, dense, report)
    # end to end, 1-token prompts: admission prefills under the full plan
    # on a tiered engine and would start the two engines apart
    one = [(p[:1], sp) for p, sp in traffic[:N_SLOTS]]
    pruned = tier_pruned(params, tier)
    res = []
    for eng, cls in ((p14_engine(cfg, params, wo), 1),
                     (p14_engine(cfg, pruned, dense, plan_tiers=None), 0)):
        uids = [eng.submit(p, max_new=P14_NEW, sampling=sp,
                           latency_class=cls) for p, sp in one]
        eng.step()
        first = eng.last_logits.clone()
        got = eng.run_until_drained()
        res.append((first, [got[u] for u in uids]))
    del pruned
    same_logits = torch.equal(bits(res[0][0]), bits(res[1][0]))
    report(f"gate 4 end to end: 4 class-1 requests on the tiered engine vs "
           f"the dense table on the tier-pruned weights: first-step logits "
           f"equal bit for bit {same_logits} (max |diff| "
           f"{(res[0][0] - res[1][0]).abs().max().item():.3e}), streams "
           f"equal {res[0][1] == res[1][1]}")
    need(same_logits and res[0][1] == res[1][1],
         "gate 4: the class-1 tier differs from the tier-pruned weights")

    # gate 5: int8, tiers (0.0, 0.5), k = 4, the first 4 requests x 8
    q8w = decode_exec_config(wo_cfg, N_SLOTS, params=params, quantize=True,
                             device="cuda")
    scaled0 = launch_counts()["block_sparse_scaled"]
    spec8 = p14_engine(cfg, params, q8w, speculate_k=P14_K)
    streams8, _ = p14_served(spec8, traffic[:N_SLOTS], "int8, k = 4",
                             max_new=8)
    plain8, _ = p14_served(p14_engine(cfg, params, q8w), traffic[:N_SLOTS],
                           "int8, k = 0", max_new=8)
    n_scaled = launch_counts()["block_sparse_scaled"] - scaled0
    report(f"gate 5 (int8): speculative streams == the int8 tiered engine's "
           f"without speculation: {streams8 == plain8}; acceptance "
           f"{spec8.speculative_acceptance():.4f} {spec8.spec_stats}; "
           f"bs_matmul_scaled launches {n_scaled}")
    need(streams8 == plain8, "gate 5: int8 speculative streams differ")
    need(spec8.spec_stats["verify_blocks"] > 0 and n_scaled > 0,
         "gate 5: no int8 verify block or bs_matmul_scaled launch")
    del q8w, spec8

    # gate 6: host logic at 2 layers
    p14_host(cfg, wo_cfg, params, traffic, report)

    # ms per emitted token, speculative against plain, each twice in turns
    report("ms per emitted token, 4 live greedy requests (tiered engine; one "
           "engine a mode, its shapes captured by a first, unreported "
           "run):")
    ms = {"speculative k 4": [], "plain": []}
    accs = []
    engines = {}
    for label in ("speculative k 4", "plain", "plain", "speculative k 4"):
        if label not in engines:
            engines[label] = p14_engine(
                cfg, params, wo, speculate_k=P14_K if label != "plain" else 0)
            p14_rate(engines[label], traffic, lambda _: None, card, label)
        t, a = p14_rate(engines[label], traffic, report, card, label)
        ms[label].append(t)
        if a is not None:
            accs.append(a)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    report(f"  means: {({k: round(v, 3) for k, v in mean.items()})} ms per "
           f"emitted token; speculative / plain "
           f"{mean['speculative k 4'] / mean['plain']:.3f}; acceptance "
           f"{[round(a, 4) for a in accs]}; device ms {prof}")
    del engines
    free()
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in ("block_sparse", "block_sparse_sum",
                                       "block_sparse_scaled",
                                       "block_sparse_scaled_sum", "output",
                                       "output_sum")}
    report(f"main-path launches (phase 14): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched in phase 14")
    report(f"phase 14 wall time: {time.perf_counter() - t_phase:.1f} s "
           f"({card})")
    return launches


# ---------------------------------------------------------------------------
# phase 15: the MoE family — DeepSeek-MoE-16B sparse decode serving
# ---------------------------------------------------------------------------

P15_ARCH = "deepseek-moe-16b"
P15_LAYERS = 14       # of 28; uncut up to PR 27, cut for the wall (PR 28)
P15_NEW = 8           # 16 up to PR 24: host-paced, it sets phase 15's wall
EXPERT_SITES = ("experts_in", "experts_gate", "experts_out")
# the expert-batched kernels; ``*_sum`` add (and scale) their partials
EXPERT_KERNELS = ("block_sparse_experts", "block_sparse_experts_sum",
                  "output_experts", "output_experts_sum",
                  "block_sparse_scaled_experts",
                  "block_sparse_scaled_experts_sum")


def prune_in_place(tree, sparsity, block) -> None:
    """Block-magnitude-prune every stacked leaf of ``tree`` (3-D and 4-D)
    but an RG-LRU block's depthwise conv taps (``conv_w``, not a matmul),
    replacing each leaf in its dict as it goes, so that at most one leaf's
    copy is alive at a time."""
    from repro_torch.core.sparsity import prune_stacked_magnitude
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            prune_in_place(leaf, sparsity, block)
        elif key != "conv_w":
            tree[key] = prune_stacked_magnitude(leaf, sparsity, block)


def p15_bring_up(report):
    """Weights, pruning, the planned two-sided config, the dense table and
    the int8 plan at full width, each timed."""
    import torch
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import decode_exec_config
    cfg = cut_config(P15_ARCH, P15_LAYERS)
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    secs = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device="cuda")
    torch.cuda.synchronize()
    secs["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prune_in_place(params, 0.5, (256, 256))
    torch.cuda.synchronize()
    secs["prune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planned = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                 device="cuda")
    dense = decode_exec_config(cfg, N_SLOTS, use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    secs["plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q8 = decode_exec_config(sp_cfg, N_SLOTS, params=params, quantize=True,
                            device="cuda")
    torch.cuda.synchronize()
    secs["quantize + int8 plan"] = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in _leaves(params))
    report(f"{P15_ARCH}: {cfg.n_layers} layers (cut from "
           f"{get_config(P15_ARCH).n_layers}; {cfg.moe.first_dense_layers}"
           f" dense), d {cfg.d_model}, {cfg.moe.n_experts} experts top-"
           f"{cfg.moe.top_k} + {cfg.moe.n_shared} shared, {n_params / 1e9:.3f}"
           f" B parameters; bring-up seconds "
           f"{({k: round(v, 1) for k, v in secs.items()})}; "
           f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
           f" GiB")
    report(planned.schedules.describe())
    report(dense.schedules.describe())
    for label, ec in (("bf16", planned), ("int8", q8)):
        skips = {}
        for e in ec.plan.entries.values():
            if e.site.startswith("moe.experts") or e.site == "moe.router":
                skips[e.site] = round(1.0 - float(e.b_bitmap.mean()), 4)
        report(f"  {label} plan weight-block skip fraction per MoE site: "
               f"{skips} (all sites {ec.plan.block_skip_fraction():.4f})")
    return cfg, sp_cfg, params, planned, dense, q8


def _leaves(tree):
    from repro_torch.core.sparsity import iter_leaves
    return iter_leaves(tree)


def expert_tols(a, w):
    """Per-expert ``matmul_tol`` of (E, M, K) @ (E, K, N): √K·2⁻²⁴·
    max(|A_e|@|B_e|), shape (E, 1, 1)."""
    import torch
    mag = torch.matmul(a.abs().float(), w.abs().float()).amax((1, 2))
    return (a.shape[-1] ** 0.5 * 2.0 ** -24 * mag)[:, None, None]


def p15_dispatch(cfg, moe_p, planned, gen):
    """A dispatch buffer built by the real router (under the plan, on the
    card) from a random (4, D) hidden state: (xe (E, C, D), share of the
    experts that got no token)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    m = cfg.moe
    x = (torch.randn((N_SLOTS, cfg.d_model), generator=gen, device="cuda")
         ).to(torch.bfloat16)
    with ops.exec_config(planned):
        _, idx = moe._route(moe_p["router"], x, m.top_k)
    cap = moe._capacity(N_SLOTS, m.top_k, m.n_experts, m.capacity_factor)
    f_sel, valid = moe._dispatch_indices(idx.reshape(-1), m.n_experts, cap)
    xe = torch.where(valid[..., None], x[f_sel // m.top_k],
                     torch.zeros((), dtype=x.dtype, device=x.device))
    empty = 1.0 - valid.any(1).float().mean().item()
    return xe, empty


def p15_expert_bs(key, site, a, p_w, wd):
    """One expert site through ``bs_matmul`` over the experts (``p_w`` the
    attached leaf of its first MoE layer, ``wd`` the weights the tolerance
    reads), held per element to the per-expert tolerance of the plain
    version, and (gate b) equal bit for bit to E launches of one expert
    each.  Returns (out, meta, operands, worst error, largest tol)."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels.ops import planned_operands
    from repro_torch.kernels.ref import (block_sparse_expert_matmul_ref,
                                         meta_at)
    xp, wp, meta, scale = planned_operands(a, p_w)
    out = bs.block_sparse_matmul(xp, wp, meta, scale=scale,
                                 out_dtype=torch.float32, rows=a.shape[1])
    plain = block_sparse_expert_matmul_ref(xp, wp, meta, scale)
    tol = expert_tols(a, wd)
    err = (out - plain).abs()
    need(bool((err <= tol).all()), f"{key} {site}: error "
         f"{err.max().item()} over the per-expert tolerance")
    for i in range(a.shape[0]):
        one = bs.block_sparse_matmul(
            xp[i], wp[i], meta_at(meta, i), out_dtype=torch.float32,
            scale=None if scale is None else scale[i], rows=a.shape[1])
        need(torch.equal(out[i], one),
             f"{key} {site}: expert {i} differs from its own launch")
    return out, meta, (xp, wp, meta, scale), err.max().item(), \
        tol.max().item()


def p15_kernels(cfg, params, planned, dense, report) -> dict:
    """Gates (a) and (b) at the first MoE layer's three expert sites in
    bf16 (``bs_matmul`` and ``fm_output`` over the experts, the dense table
    == the plan), and the operands of the expert kernels' times at
    experts_in for the kernels line.  ``acts`` keeps each site's
    operand for ``p15_kernels_int8``."""
    import torch
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import expert_matmul_ref
    from repro_torch.models import moe
    from repro_torch.models.transformer import index_tree
    gen = torch.Generator(device="cuda").manual_seed(15)
    att = planned.plan.attach(params, verify=False)
    moe_p = index_tree(att["stack"]["layers"]["moe"], 0)
    raw = {k: params["stack"]["layers"]["moe"][k][0] for k in EXPERT_SITES}
    xe, empty = p15_dispatch(cfg, moe_p, planned, gen)
    # the operands the path gives each site: experts_out takes silu(g)·h
    h = expert_matmul_ref(xe, raw["experts_in"]).to(torch.bfloat16)
    g = expert_matmul_ref(xe, raw["experts_gate"]).to(torch.bfloat16)
    acts = {"experts_in": xe, "experts_gate": xe,
            "experts_out": moe._act_mul(g, h)}
    worst = dict.fromkeys(("block_sparse_experts", "output_experts"), 0.0)
    keep = {"acts": acts}
    for site in EXPERT_SITES:
        a, w = acts[site], raw[site]
        pw = moe_p[site]
        sched = dense.schedules.sites[f"moe.{site}"].schedule
        out, meta, operands, err_bs, tol_bs = p15_expert_bs(
            "block_sparse_experts", site, a, pw, w)
        worst["block_sparse_experts"] = max(worst["block_sparse_experts"],
                                            err_bs)
        dense_out = fm.flex_matmul(a, w, schedule=sched,
                                   out_dtype=torch.float32)
        err = (dense_out - expert_matmul_ref(a, w)).abs()
        need(bool((err <= expert_tols(a, w)).all()),
             f"output_experts {site}: error {err.max().item()}")
        for i in range(a.shape[0]):
            need(torch.equal(dense_out[i], fm.flex_matmul(
                a[i], w[i], schedule=sched, out_dtype=torch.float32)),
                f"output_experts {site}: expert {i} differs from its own "
                f"fm_output launch")
        worst["output_experts"] = max(worst["output_experts"],
                                      err.max().item())
        need(torch.equal(dense_out, out),
             f"{site}: the dense table differs from the plan")
        empty_lists = (meta.kcnt == 0).float().mean().item()
        if site == "experts_in":
            xp, wp, meta_in, scale = operands
            keep["block_sparse_experts"] = (xp, wp.clone(), meta_in, scale,
                                            w)
            keep["output_experts"] = (a, w, sched)
        report(f"  {site} (E {a.shape[0]}, C {a.shape[1]}, K {a.shape[2]}, "
               f"N {w.shape[-1]}): bs_matmul experts ({pw.bm},{pw.bk},"
               f"{pw.bn}) err {err_bs:.3e} (tol up to {tol_bs:.3e}), "
               f"fm_output experts ({sched.bm},{sched.bn},{sched.bk}) err "
               f"{err.max().item():.3e}; batched == per-expert launches bit "
               f"for bit; dense table == plan bitwise; empty tile lists "
               f"{empty_lists:.4f}")
    report(f"dispatch buffer from the real router: {empty:.4f} of the "
           f"experts got no token")
    keep["errs"] = worst
    keep["empty"] = empty
    return keep


def p15_kernels_int8(params, q8, dense, acts, report) -> dict:
    """Gates (a) and (b) of the int8 kernels at the first MoE layer's three
    expert sites, on ``p15_kernels``' operands ``acts``:
    ``bs_matmul_scaled`` over the experts, and int8 at the dense table.
    Returns the experts_in operands and the worst error under the key
    block_sparse_scaled_experts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import expert_matmul_ref
    from repro_torch.quant.quantize import dequantize_leaf, quantize_params
    key = "block_sparse_scaled_experts"
    q8p = quantize_params(params)[0]
    att8 = q8.plan.attach(q8p, verify=False)
    worst, keep = 0.0, {}
    for site in EXPERT_SITES:
        a = acts[site]
        pw8 = att8["stack"]["layers"]["moe"][site].index(0)
        _, _, operands, err_bs, tol_bs = p15_expert_bs(
            key, site, a, pw8, pw8.w_kn)
        worst = max(worst, err_bs)
        if site == "experts_in":
            # a copy of the layer's slice: a view would keep the whole
            # int8 leaf of ``q8p`` alive
            xp, wp, meta, scale = operands
            keep[key] = (xp, wp.clone(), meta, scale, pw8.w_kn)
        # int8 at the dense table: an unplanned int8 stack is dequantized
        # to the activation's dtype first (as the reference's), then the
        # batched fm_output runs on it.  Both sides round a float32 sum to
        # bf16, so they may differ by the float32 tolerance plus one bf16
        # ulp of the larger (2⁻⁷ of it at most)
        q = q8p["stack"]["layers"]["moe"][site].index(0)
        with ops.exec_config(dense):
            out8 = ops.flex_expert_matmul(a, q, site=f"moe.{site}")
        w8 = dequantize_leaf(q, torch.bfloat16)
        ref8 = expert_matmul_ref(a, w8).to(torch.bfloat16)
        err8 = (out8.float() - ref8.float()).abs()
        ulp = 2.0 ** -7 * torch.maximum(out8.float().abs(),
                                        ref8.float().abs())
        need(bool((err8 <= expert_tols(a, w8) + ulp).all()),
             f"int8 dense table {site}: error {err8.max().item()}")
        report(f"  {site} int8: bs_matmul_scaled experts ({pw8.bm},"
               f"{pw8.bk},{pw8.bn}) err {err_bs:.3e} (tol up to "
               f"{tol_bs:.3e}), batched == per-expert launches bit for bit;"
               f" int8 at the dense table (dequantized to bf16 first) err "
               f"{err8.max().item():.3e}")
    keep["errs"] = {key: worst}
    return keep


def p15_router(cfg, params, planned, dense, report) -> None:
    """Gate (c): the float32 router at decode (M = 4): planned == dense
    table bitwise, kernel within the float32 tolerance of plain, and the
    top-k sets of the kernel's and the plain router's probabilities, with
    the probability margin of every flip."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.models import moe
    gen = torch.Generator(device="cuda").manual_seed(16)
    att = planned.plan.attach(params, verify=False)
    k = cfg.moe.top_k
    flips, margins, worst, tol_max, rows = 0, [], 0.0, 0.0, 0
    for layer in range(cfg.n_layers - cfg.moe.first_dense_layers):
        r_plan = att["stack"]["layers"]["moe"]["router"].index(layer)
        r_raw = params["stack"]["layers"]["moe"]["router"][layer]
        for _ in range(4):
            x = torch.randn((N_SLOTS, cfg.d_model), generator=gen,
                            device="cuda")
            with ops.exec_config(planned):
                lp = ops.flex_matmul(x, r_plan, site="moe.router")
            with ops.exec_config(dense):
                ld = ops.flex_matmul(x, r_raw, site="moe.router")
            need(torch.equal(lp, ld), f"router layer {layer}: planned != "
                 "dense table")
            plain = matmul_ref(x, r_raw)
            tol = matmul_tol(x, r_raw)
            err = (lp - plain).abs().max().item()
            need(err <= tol, f"router layer {layer}: error {err} > {tol}")
            worst, tol_max = max(worst, err), max(tol_max, tol)
            pk, ik = moe.top_k(torch.softmax(lp, -1), k + 1)
            _, ip = moe.top_k(torch.softmax(plain, -1), k)
            diff = (ik[:, :k].sort(-1).values != ip.sort(-1).values).any(-1)
            flips += int(diff.sum())
            margins += (pk[:, k - 1] - pk[:, k])[diff].tolist()
            rows += N_SLOTS
    report(f"router (float32, M {N_SLOTS}, {rows} rows over every MoE "
           f"layer): planned == dense table bitwise; kernel vs plain max "
           f"err {worst:.3e} (tol up to {tol_max:.3e}); top-{k} set flips "
           f"kernel vs plain: {flips} of {rows} rows, margins {margins}")


def p15_layer(cfg, params, planned, report) -> None:
    """Gate (d): the first MoE layer's ``apply_moe`` under the plan (the
    kernels) against ``apply_moe_gshard`` (plain one-hot products, raw
    weights) routed by the same router logits.  bf16: within 2⁻⁶ of
    max |y|, two bf16 ulps of the largest element (the paths round their
    bf16 intermediates at different points)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.transformer import index_tree
    gen = torch.Generator(device="cuda").manual_seed(17)
    att = planned.plan.attach(params, verify=False)
    p_plan = index_tree(att["stack"]["layers"]["moe"], 0)
    p_raw = index_tree(params["stack"]["layers"]["moe"], 0)
    x = torch.randn((N_SLOTS, 1, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with ops.exec_config(planned):
        y = moe.apply_moe(p_plan, cfg, x)
        logits = ops.flex_matmul(x.reshape(N_SLOTS, -1).float(),
                                 p_plan["router"], site="moe.router")
    y_or = moe.apply_moe_gshard(p_raw, cfg, x, router_logits=logits)
    err = (y.float() - y_or.float()).abs().max().item()
    bar = 2.0 ** -6 * y_or.float().abs().max().item()
    report(f"MoE layer 1: apply_moe (kernels, plan) vs apply_moe_gshard "
           f"(same logits): max |diff| {err:.3e}, bar {bar:.3e}")
    need(bool(torch.isfinite(y).all()) and y.shape == x.shape,
         "MoE layer output not finite")
    need(err <= bar, f"MoE layer: {err} > {bar}")


def free():
    """Collect what the caller dropped: ``drain_timed`` leaves an engine in
    a reference cycle (its patched methods), and an int8 engine holds a
    15 GiB copy of the weights."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def p15_profile(eng, report) -> None:
    """One profiled ``step()``: device busy share, kernels, launches of the
    expert kernels in that step, and the top device operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    before = launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    after = launch_counts()
    step = {k: after[k] - before[k] for k in EXPERT_KERNELS + (
        "block_sparse", "block_sparse_sum") if after[k] != before[k]}
    busy, n_kernels, fam = device_breakdown(prof)
    top = device_tops(prof, 8)
    if not busy:
        report("profiled MoE decode step: the profiler recorded no device "
               "time (not measured)")
    else:
        report(f"profiled MoE decode step (planned): wall {wall * 1e3:.2f} "
               f"ms, device busy {busy / 1e3:.2f} ms "
               f"({100 * busy / 1e3 / (wall * 1e3):.1f}% of wall, "
               f"{n_kernels} kernels); by family {fam}; top device "
               f"operations {[(n[:60], round(us / 1e3, 3), c) for n, (us, c) in top]}")
    p15_step_device(eng, report, round(busy / 1e3, 3) if busy else None)
    n_moe = eng.cfg.n_layers - eng.cfg.moe.first_dense_layers
    report(f"expert-site launches in that step: {step} (one per site and "
           f"MoE layer: {3 * n_moe}, against {3 * n_moe * eng.cfg.moe.n_experts}"
           f" launched expert by expert)")
    need(step.get("block_sparse_experts") == 3 * n_moe,
         f"expert launches per step {step}, not {3 * n_moe}")


def p15_step_device(eng, report, step_busy_ms, label="MoE") -> None:
    """The profiled step's model call — ``masked_decode_step`` under the
    plan on a copy of the engine's state, every slot live — timed by
    ``torch.profiler`` (summed kernel time) and by ``device_ms`` (a CUDA
    graph replay: the card's time with the host out of the way), with its
    synchronizing calls: the check of the profiler's busy time.  Its
    launches are not the main path's: the counts are put back after."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import model as model_lib
    saved = launch_counts()
    live = eng._live()
    toks = eng._to_device(eng._current_tokens(live)[:, None])
    pos = eng._to_device(eng._slot_positions())
    mask = eng._live_mask(live)
    st = {g: {n: t.clone() for n, t in grp.items()}
          for g, grp in eng.state.items()}

    def call():
        return model_lib.masked_decode_step(eng._tier_params[0], eng.cfg,
                                            toks, st, pos, mask)
    with eng._scope():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        busy, n_kernels, _ = device_breakdown(prof)
        syncs = count_syncs(call)
        d_ms = device_ms(call, calls=1, replays=5)
    reset_launches(saved)
    graph = "not measured" if d_ms is None else f"{d_ms:.3f} ms"
    diff = ("" if d_ms is None or not busy else
            f" (profiler / graph {busy / 1e3 / d_ms:.4f})")
    report(f"{label} decode step's model call (masked_decode_step, "
           f"planned, {len(live)} live rows): profiler {busy / 1e3:.3f} ms over "
           f"{n_kernels} kernels (the engine step's profile: "
           f"{step_busy_ms} ms); device_ms (CUDA graph replay) {graph}"
           f"{diff}; synchronizing calls {syncs}")


def p15_empty_lists(eng) -> float:
    """Share of the expert kernels' tile lists that were empty (kcnt 0:
    no live activation block met a live weight block) over one decode
    step's model call — the router acting as FlexNN's activation bitmap.
    The call runs eagerly on a copy of the engine's state (a replayed
    ``step()`` runs no Python to watch); its launches are put back."""
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.models import model as model_lib
    orig = bs.block_sparse_matmul
    seen = []

    def spy(a, b, meta, **kw):
        if a.dim() == 3:                  # the expert sites
            seen.append(((meta.kcnt == 0).sum(), meta.kcnt.numel()))
        return orig(a, b, meta, **kw)
    saved = launch_counts()
    live = eng._live()
    bs.block_sparse_matmul = spy
    try:
        with eng._scope():
            model_lib.masked_decode_step(
                eng._tier_params[0], eng.cfg,
                eng._to_device(eng._current_tokens(live)[:, None]),
                tree_copy(eng.state), eng._to_device(eng._slot_positions()),
                eng._live_mask(live))
    finally:
        bs.block_sparse_matmul = orig
    reset_launches(saved)
    empty = sum(int(e) for e, _ in seen)
    return empty / max(sum(n for _, n in seen), 1)


def p15_serve(cfg, params, planned, dense, q8, report, card) -> dict:
    """Gate (e) through ``family_serve`` (bf16 with the dense-table gate,
    the planned oracle's first step profiled; int8 on the first two
    requests) and the engine numbers.  Returns the launches of the
    phase's engine runs."""
    prompts = family_prompts(cfg, seed=15)
    reset_launches()
    empty = []

    def on_oracle(oracle):
        p15_profile(oracle, report)
        empty.append(p15_empty_lists(oracle))
    _, streams, _ = family_serve(cfg, params, planned, dense, report, card,
                                 prompts=prompts, max_new=P15_NEW,
                                 on_oracle=on_oracle)
    report(f"empty expert tile lists in a step: {empty[0]:.4f}")
    _, q_streams, _ = family_serve(cfg, params, q8, None, report, card,
                                   label="int8 (first 2 requests)",
                                   prompts=prompts[:2], max_new=P15_NEW)
    report(f"int8 vs bf16 first two streams equal: "
           f"{q_streams == streams[:2]}")
    counts = launch_counts()
    launches = {k: counts[k] for k in EXPERT_KERNELS + (
        "block_sparse", "block_sparse_sum", "block_sparse_scaled",
        "block_sparse_scaled_sum", "output", "output_sum")}
    report(f"main-path launches (phase 15, the five engine runs): "
           f"{launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched in phase 15")
    return launches


def time_expert_kernels(t, launches) -> list:
    """The expert kernels' rows of the ``kernels`` line, at the first MoE
    layer's experts_in (E 64, C 1, K 2048, N 1408) on the real router's
    dispatch buffer: time, plain version (2-D plain versions per expert),
    bound, ``torch.bmm`` on the dense weights; the block-sparse rows add
    the time of the E 2-D launches that the batched launch replaces."""
    import torch
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import (block_sparse_expert_matmul_ref,
                                         expert_matmul_ref, meta_at)
    saved = launch_counts()
    rows = []
    a, w, sched = t["output_experts"]
    lib_ms = cuda_ms(lambda: torch.bmm(a, w))
    lib_device_ms = device_ms(lambda: torch.bmm(a, w))
    for key, name, replaces in (
            ("block_sparse_experts", "block_sparse_experts",
             "src/repro/kernels/block_sparse.py:49"),
            ("block_sparse_scaled_experts", "block_sparse_scaled_experts",
             "src/repro/kernels/block_sparse.py:69")):
        xp, wp, meta, scale, _ = t[key]
        blocks = (xp.shape[1] // meta.a_bitmap.shape[-2],
                  xp.shape[2] // meta.a_bitmap.shape[-1],
                  wp.shape[2] // meta.b_bitmap.shape[-1])
        b_ms, b_by = bs_bound_ms(xp, meta, blocks,
                                 w_elem=wp.element_size(),
                                 scale_elem=0 if scale is None else 4)

        def call(xp=xp, wp=wp, meta=meta, scale=scale):
            return bs.block_sparse_matmul(
                xp, wp, meta, scale=scale, out_dtype=torch.float32)
        def per_expert(xp=xp, wp=wp, meta=meta, scale=scale):
            return [bs.block_sparse_matmul(
                xp[i], wp[i], meta_at(meta, i), out_dtype=torch.float32,
                scale=None if scale is None else scale[i])
                for i in range(xp.shape[0])]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_sparse.cu",
            "replaces": replaces,
            "launches": launches[key],
            "launches_sum": launches[f"{key}_sum"],
            "max_abs_err": t["errs"][key],
            "ms": cuda_ms(call),
            "plain_ms": cuda_ms(lambda: block_sparse_expert_matmul_ref(
                xp, wp, meta, scale)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": device_ms(call),
            "library_device_ms": lib_device_ms,
            "per_expert_launches_ms": cuda_ms(per_expert, iters=5),
            "per_expert_launches_device_ms": device_ms(per_expert, calls=5)})
    e, m, k = a.shape
    n = w.shape[-1]
    b_ms, b_by = bound_ms(a.numel() * 2 + w.numel() * 2 + e * m * n * 4,
                          2.0 * e * m * n * k)

    def fm_call():
        return fm.flex_matmul(a, w, schedule=sched, out_dtype=torch.float32)
    rows.append({
        "name": "flex_output_experts", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flex_matmul.cu",
        "replaces": "src/repro/kernels/flex_matmul.py:52",
        "launches": launches["output_experts"],
        "launches_sum": launches["output_experts_sum"],
        "max_abs_err": t["errs"]["output_experts"],
        "ms": cuda_ms(fm_call),
        "plain_ms": cuda_ms(lambda: expert_matmul_ref(a, w)),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "device_ms": device_ms(fm_call),
        "library_device_ms": lib_device_ms})
    reset_launches(saved)
    return rows


def run_moe(report, card):
    """Phase 15.  Returns (its launches, the expert kernels' rows)."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, sp_cfg, params, planned, dense, q8 = p15_bring_up(report)
    checked = p15_kernels(cfg, params, planned, dense, report)
    checked8 = p15_kernels_int8(params, q8, dense, checked.pop("acts"),
                                report)
    checked["errs"].update(checked8.pop("errs"))
    checked.update(checked8)
    del checked8
    p15_router(cfg, params, planned, dense, report)
    p15_layer(cfg, params, planned, report)
    launches = p15_serve(cfg, params, planned, dense, q8, report, card)
    rows = time_expert_kernels(checked, launches)
    executables = p23_moe(cfg, params, planned, report, card)
    report(f"phase 15 peak memory: max_memory_allocated "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
           f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}"
           f" GiB ({card})")
    report(f"phase 15 wall time: {time.perf_counter() - t_phase:.1f} s "
           f"({card})")
    return launches, rows, executables


def p23_moe(cfg, params, planned, report, card) -> dict:
    """Phase 23 on DeepSeek-MoE-16B (phase 15's 14 layers, 4 slots, bf16
    planned): admission and the first block captured (seconds, graphs,
    pool bytes), then ``p23_block``.  The launches are put back."""
    saved = launch_counts()
    t0 = time.perf_counter()
    eng = p23_engine(cfg, params, planned)
    p23_live(eng, family_prompts(cfg, seed=15))
    report(f"MoE planned engine: admission and the first block "
           f"{time.perf_counter() - t0:.2f} s, {graph_stats(eng)} ({card})")
    out = p23_block(eng, report, card, "MoE planned")
    out["graphs"] = graph_stats(eng)
    del eng
    free()
    reset_launches(saved)
    report(f"phase 23 (DeepSeek-MoE-16B) wall time: "
           f"{time.perf_counter() - t0:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phases 16-17: the rest of the dense family and the Griffin hybrid
# ---------------------------------------------------------------------------

P16_ARCHS = ("yi-9b", "gemma-2b", "chatglm3-6b")
# the depth phase 16 keeps of the configs it cuts (published: 48, 28),
# which holds the script within its time limit with phase 24 added
P16_LAYERS = {"yi-9b": 6, "chatglm3-6b": 4}
P17_ARCH = "recurrentgemma-9b"
FAMILY_NEW = 8
FAMILY_MAX_SEQ = 64
# the flash kernel at head dim 256, at the two prefill cells of 2 x 4096
# tokens: gemma-2b's (8 query heads of one kv head, BH 16, causal) and
# recurrentgemma-9b's (16 query heads, BH 32, window 2048); the first case
# of each list is the cell
FLASH256_CASES = {
    "gemma-2b": (
        ("gemma-2b cell, causal", 16, 4096, 4096, True, 0),
        ("Sq < Skv, causal", 16, 128, 4096, True, 0),
        ("window 2048", 16, 4096, 4096, True, 2048),
        ("non-causal", 16, 4096, 4096, False, 0)),
    "recurrentgemma-9b": (
        ("recurrentgemma-9b cell, window 2048", 32, 4096, 4096, True, 2048),
        ("causal", 32, 4096, 4096, True, 0),
        ("Sq < Skv, window 2048", 32, 128, 4096, True, 2048),
        ("non-causal", 32, 4096, 4096, False, 0)),
}
FAMILY_KERNELS = ("block_sparse", "block_sparse_sum", "output", "output_sum")


def family_bring_up(arch, report, layers=None):
    """One config at its published width and depth (``layers``: cut to
    that many): weights (seed 0),
    every stacked matmul weight pruned to 50% at (256, 256) (the head and
    the embedding dense), the planned two-sided config and the dense
    table, each timed.  Both run the kernels (``use_kernels``): a tied
    head is never planned, and its dense site must take ``fm_output`` in
    the plan as in the table for the two to agree bit for bit."""
    import torch
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import decode_exec_config
    cfg = cut_config(arch, layers)
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device="cuda")
    torch.cuda.synchronize()
    secs["init"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prune_in_place(params, 0.5, (256, 256))
    torch.cuda.synchronize()
    secs["prune"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planned = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                 use_kernels=True, device="cuda")
    dense = decode_exec_config(cfg, N_SLOTS, use_kernels=True, device="cuda")
    torch.cuda.synchronize()
    secs["plan"] = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in _leaves(params))
    cut = (f" (cut from {get_config(arch).n_layers})" if layers is not None
           else "")
    report(f"{arch}: {cfg.n_layers} layers{cut}, d {cfg.d_model}, "
           f"{cfg.n_heads} "
           f"heads of {cfg.head_dim} over {cfg.n_kv_heads} kv, d_ff "
           f"{cfg.d_ff}, vocab {cfg.vocab}, tied head {cfg.tie_embeddings}; "
           f"{n_params / 1e9:.3f} B parameters; bring-up seconds "
           f"{({k: round(v, 1) for k, v in secs.items()})}; weight-block "
           f"skip fraction {planned.plan.block_skip_fraction():.4f}; "
           f"max_memory_allocated "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    report(planned.schedules.describe())
    return cfg, sp_cfg, params, planned, dense


def check_tied_head(params, dense, report) -> float:
    """A tied head is never planned: the logits contraction runs the dense
    table's ``lm_head`` schedule on the embedding's transposed view, in
    the plan as in the table.  That kernel against its plain version at
    the decode M, bf16 and float32 (``matmul_tol``, with the TF32
    control).  Returns the worst error."""
    import torch
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import matmul_ref
    desc = dense.schedules.sites["lm_head"]
    sched = desc.schedule
    emb = params["embed"]
    gen = torch.Generator(device="cuda").manual_seed(4)
    a_full = torch.randn((desc.m, emb.shape[1]), generator=gen,
                         device="cuda")
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        a, w_kn = a_full.to(dtype), emb.to(dtype).t()
        tol = matmul_tol(a, w_kn)
        plain = matmul_ref(a, w_kn)
        out = fm.flex_matmul(a, w_kn, schedule=sched,
                             out_dtype=torch.float32)
        err = (out - plain).abs().max().item()
        line = (f"tied lm_head {str(dtype)[6:]} M={desc.m} K={w_kn.shape[0]}"
                f" N={w_kn.shape[1]} (B read transposed): flex_"
                f"{sched.stationarity} ({sched.bm},{sched.bn},{sched.bk}) "
                f"{err:.3e}; tol {tol:.3e}")
        need(err <= tol, f"tied lm_head {dtype}: error {err} > {tol}")
        if dtype is torch.float32:
            ctrl = (matmul_ref(tf32(a), tf32(w_kn)) - plain).abs().max() \
                .item()
            line += f"; TF32 control {ctrl:.3e} (must exceed tol)"
            need(ctrl > tol, f"tied lm_head: the float32 tolerance does "
                 f"not reject TF32 operands ({ctrl})")
        report(line)
        worst = max(worst, err)
        del a, w_kn, plain, out
    free()
    return worst


def family_engine(cfg, params, exec_cfg, fused=True, max_new=FAMILY_NEW,
                  **kw):
    """The decode gates' engine: 4 slots, ``max_seq`` 64, a bf16 decode
    state, fused blocks of ``max_new`` (one block per request), blocks read
    synchronously; ``kw`` overrides any of these."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    kw = {"n_slots": N_SLOTS, "max_seq": FAMILY_MAX_SEQ,
          "dtype": torch.bfloat16, "async_dispatch": False, **kw}
    return ServeEngine(cfg, params, exec_cfg=exec_cfg, fused=fused,
                       decode_block=max_new, device="cuda", **kw)


def family_prompts(cfg, seed=16):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(rng.integers(8, 17)))
            for _ in range(N_SLOTS)]


def first_step(cfg, params, exec_cfg, prompts, fused=True,
               max_new=FAMILY_NEW, **kw):
    """An engine with ``prompts`` submitted after one ``step()`` (all
    admitted, one decode step): (engine, uids, that step's logits)."""
    eng = family_engine(cfg, params, exec_cfg, fused=fused, max_new=max_new,
                        **kw)
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.step()
    return eng, uids, eng.last_logits.clone()


def family_serve(cfg, params, planned, dense, report, card, label="bf16",
                 prompts=None, max_new=FAMILY_NEW, on_oracle=None,
                 rates=None, **kw):
    """The decode gates of phases 4-5 (and 7 for int8), shared by phases
    15-20 and 24: the planned engine's fused streams equal its ``step()``
    oracle's (``on_oracle`` sees the oracle after its first step), and,
    unless ``dense`` is None, the dense table's first-step logits and
    streams equal the plan's bit for bit.  ``kw`` goes to every engine
    (``family_engine``).  Launches are counted by the caller; ``rates``,
    a dict, gets the planned engine's tokens/s and ms per decode step.
    Returns (prompts, streams, the oracle's first-step logits)."""
    import torch
    if prompts is None:
        prompts = family_prompts(cfg)
    eng = family_engine(cfg, params, planned, max_new=max_new, **kw)
    streams, wall, timing = drain_timed(eng, prompts, max_new)
    report(f"{cfg.name} {label} planned engine (fused blocks of "
           f"{max_new}): {rate_line(streams, wall, timing)} ({card})")
    if rates is not None:
        # the same requests again on the warm engine: every entry point
        # replays its captured graph
        again, wall, timing = drain_timed(eng, prompts, max_new)
        need(again == streams, f"{cfg.name} {label}: the warm engine's "
             f"streams differ from the first drain's")
        rates.update(tokens_per_s=sum(len(st) for st in again) / wall,
                     ms_per_decode_step=1e3 * timing["decode"]
                     / timing["steps"], feed_s=timing["prefill"])
        report(f"{cfg.name} {label} planned engine, the same requests "
               f"replayed on the warm engine: "
               f"{rate_line(again, wall, timing)}; streams equal the "
               f"first drain's ({card})")
    del eng
    free()
    oracle, ouids, logits_p = first_step(cfg, params, planned, prompts,
                                         fused=False, max_new=max_new, **kw)
    if on_oracle is not None:
        on_oracle(oracle)
    ores = oracle.run_until_drained()
    same = [ores[u] for u in ouids] == streams
    report(f"{cfg.name} {label}: fused streams == step() oracle: {same}")
    need(same, f"{cfg.name} {label}: fused streams differ from the step() "
         f"oracle")
    need(bool(torch.isfinite(logits_p).all())
         and logits_p.shape == (N_SLOTS, cfg.vocab),
         f"{cfg.name} {label}: bad logits")
    del oracle
    free()
    if dense is None:
        return prompts, streams, logits_p
    de, duids, logits_d = first_step(cfg, params, dense, prompts,
                                     max_new=max_new, **kw)
    dres = de.run_until_drained()
    same_l = torch.equal(logits_p, logits_d)
    same_s = [dres[u] for u in duids] == streams
    report(f"{cfg.name} {label}: dense table vs plan: first-step logits "
           f"equal bit for bit {same_l} (max |diff| "
           f"{(logits_p - logits_d).abs().max().item():.3e}), streams equal "
           f"{same_s}")
    need(same_l and same_s, f"{cfg.name} {label}: the dense table differs "
         f"from the plan")
    del de
    free()
    return prompts, streams, logits_p


def family_plain(cfg, params, prompts, logits_p, report, exec_cfg=None,
                 label="plain torch.matmul, no kernels", routed_as=None):
    """The plain engine's first-step logits within 5% of max |logit| of
    the plan's (every matmul's bf16 output is re-rounded, so 1-ulp
    differences compound through the layers, as in phase 5).  With
    ``routed_as`` (a MoE stack's planned exec config) bf16 roundings flip
    top-k choices between the kernel and the plain router, and a flipped
    token takes another expert's output: the plain first step then takes
    the planned one's expert choices (``same_routing``, as phase 22's
    plain step does), both run eagerly (``eager_entries``: a replayed
    graph runs no Python to route), the eager planned step must equal the
    replayed oracle's ``logits_p`` bit for bit, and the flips are
    counted."""
    import torch
    tape = {"idx": [], "flips": 0}
    runs = [(exec_cfg, True)]
    if routed_as is not None:
        runs.insert(0, (routed_as, False))
    for ec, replay in runs:
        eng = family_engine(cfg, params, ec, fused=False)
        if routed_as is not None:
            eager_entries(eng)
        for p in prompts:
            eng.submit(p, max_new=FAMILY_NEW)
        with (same_routing(tape, replay=replay) if routed_as is not None
              else contextlib.nullcontext()):
            eng.step()
        logits = eng.last_logits.clone()
        del eng
        free()
        if not replay:
            need(torch.equal(logits, logits_p), f"{cfg.name}: the eager "
                 f"planned step differs from the replayed oracle's")
    diff = (logits - logits_p).abs().max().item()
    tol = 0.05 * logits_p.abs().max().item()
    if routed_as is not None:
        label += (f", routed as the planned engine (its own router would "
                  f"send {tape['flips']} of "
                  f"{sum(t.shape[0] for t in tape['idx'])} (row, layer) "
                  f"choices of admission and the first step to another "
                  f"expert; the eager planned step == the replayed oracle's"
                  f" bit for bit)")
    report(f"{cfg.name} {label}: first-step logits vs planned max |diff| = "
           f"{diff:.3e}, tol {tol:.3e}")
    need(diff <= tol, f"{cfg.name} {label}: logits off by {diff}")


def family_prefill(cfg, sp_cfg, params, report, card, with_cache):
    """A 2 x 4096 prefill through the hd-256 flash kernel: the dense
    prefill table (flash launches = attention layers), the planned plan
    (logits equal bit for bit), the plain path (within 5% of max |logit|)
    and, for dense stacks, ``prefill_with_cache`` (logits equal
    ``prefill``'s).  Returns the flash launches (per prefill, over the
    phase's prefills)."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.models.transformer import griffin_layout
    from repro_torch.serve.engine import shape_exec_config
    shape = prefill_shape()
    b, s = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    dense_pf = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
    planned_pf = shape_exec_config(sp_cfg, shape, use_kernels=True,
                                   params=params, device="cuda")
    attached = planned_pf.plan.attach(params)
    report(f"{cfg.name} prefill table and plan bring-up: "
           f"{time.perf_counter() - t0:.1f} s")
    batch = {"tokens": torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, size=(b, s)), device="cuda")}
    n_attn = cfg.n_layers
    if cfg.rglru.enabled:
        n_attn = griffin_layout(cfg)[0] * cfg.rglru.block_pattern.count(
            "attn")

    def prefill(ec, p):
        return _under(ec, lambda: model_lib.prefill(p, cfg, batch))

    before = launch_counts()["flash_attention"]
    logits, wall = _timed(lambda: prefill(dense_pf, params))
    per_prefill = launch_counts()["flash_attention"] - before
    report(f"{cfg.name} bf16 prefill, dense table: {wall:.3f} s for {b} x "
           f"{s} tokens = {1e3 * wall / (b * s):.4f} ms per prompt token; "
           f"{per_prefill} flash launches at hd {cfg.head_dim}"
           f"{f', window {cfg.window}' if cfg.window else ''} ({card})")
    need(per_prefill == n_attn, f"{cfg.name}: flash kernel launched "
         f"{per_prefill} times in one prefill, not {n_attn}")
    need(bool(torch.isfinite(logits).all())
         and logits.shape == (b, 1, cfg.vocab), f"{cfg.name}: bad prefill "
         f"logits")
    logits_p, wall = _timed(lambda: prefill(planned_pf, attached))
    same = torch.equal(logits_p, logits)
    report(f"{cfg.name} bf16 prefill, planned (skip fraction "
           f"{planned_pf.plan.block_skip_fraction():.4f}): {wall:.3f} s; "
           f"logits == dense table bit for bit: {same}")
    need(same, f"{cfg.name}: planned prefill logits differ from the dense "
         f"table's")
    logits_0, wall = _timed(lambda: prefill(None, params))
    diff = (logits_0 - logits).abs().max().item()
    tol = 0.05 * logits.abs().max().item()
    report(f"{cfg.name} bf16 prefill, plain: {wall:.3f} s; logits vs dense "
           f"table max |diff| = {diff:.3e}, tol {tol:.3e}")
    need(diff <= tol, f"{cfg.name}: plain prefill logits off by {diff}")
    if with_cache:
        (logits_c, _), wall = _timed(lambda: _under(
            dense_pf, lambda: model_lib.prefill_with_cache(
                params, cfg, batch, s + 16)))
        same = torch.equal(logits_c, logits)
        report(f"{cfg.name} bf16 prefill_with_cache, dense table: "
               f"{wall:.3f} s; logits == prefill: {same}")
        need(same, f"{cfg.name}: prefill_with_cache logits differ from "
             f"prefill's")
    total = launch_counts()["flash_attention"] - before
    profile_prefill(lambda: prefill(dense_pf, params), report,
                    f"{cfg.name} bf16 prefill (dense table)")
    del dense_pf, planned_pf, attached
    free()
    return {"per_prefill": per_prefill, "total": total}


def family_int8(cfg, sp_cfg, params, report, card):
    """int8 (``quantize=True``; a tied head stays the bf16 embedding): the
    int8 kernels against their plain versions at layer 0's sites
    (``check_sites_int8``; those launches are not counted), the planned
    int8 engine's fused streams equal its ``step()`` oracle's, and the
    dense int8 table's first-step logits equal the plan's bit for bit.
    Returns the int8 kernels' worst errors."""
    from repro_torch.serve.engine import decode_exec_config
    t0 = time.perf_counter()
    q8 = decode_exec_config(sp_cfg, N_SLOTS, params=params, quantize=True,
                            use_kernels=True, device="cuda")
    dense8 = decode_exec_config(cfg, N_SLOTS, use_kernels=True,
                                quantize=True, device="cuda")
    report(f"{cfg.name} int8 plan bring-up: {time.perf_counter() - t0:.1f} "
           f"s; weight-block skip fraction "
           f"{q8.plan.block_skip_fraction():.4f}; head planned: "
           f"{'lm_head' in q8.plan.entries}")
    saved = launch_counts()
    errs = check_sites_int8(cfg, params, q8, report)["errs"]
    reset_launches(saved)
    free()
    family_serve(cfg, params, q8, dense8, report, card, label="int8")
    del q8, dense8
    free()
    return errs


def run_family(arch, report, card, flash_rows):
    """One config of phase 16 or 17, freed at the end.  Returns its
    main-path launches and the matmul kernels' worst errors against their
    plain versions at its sites."""
    import torch
    t0 = time.perf_counter()
    if arch in FLASH256_CASES:
        checked = check_flash(report, FLASH256_CASES[arch], hd=256, seed=16)
    cfg, sp_cfg, params, planned, dense = family_bring_up(
        arch, report, layers=P16_LAYERS.get(arch))
    report(f"{arch}: the matmul kernels vs their plain versions at layer "
           f"0's sites")
    errs = check_sites(params, planned, dense, report)["errs"]
    if cfg.tie_embeddings:
        errs["output"] = max(errs["output"],
                             check_tied_head(params, dense, report))
    free()
    reset_launches()
    prompts, _, logits_p = family_serve(cfg, params, planned, dense, report,
                                        card)
    family_plain(cfg, params, prompts, logits_p, report)
    kernels = FAMILY_KERNELS
    if arch == "gemma-2b":
        errs.update(family_int8(cfg, sp_cfg, params, report, card))
        kernels += INT8_KERNELS
    if arch in FLASH256_CASES:
        pf = family_prefill(cfg, sp_cfg, params, report, card,
                            with_cache=not cfg.rglru.enabled)
        kernels += ("flash_attention",)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in kernels}
    report(f"main-path launches ({arch}): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched in {arch}'s run")
    report(f"{arch} peak memory: max_memory_allocated "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall "
           f"{time.perf_counter() - t0:.1f} s ({card})")
    del params, planned, dense
    free()
    if arch in FLASH256_CASES:
        name = "flash_attention_hd256" + ("_window" if cfg.window else "")
        flash_rows.append(time_flash(checked, pf, name=name))
        del checked
        free()
    report(f"{arch} matmul kernels' worst errors: {errs}")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 18: FlexNN's analytic core on the card, the ZVC codec on real
# tensors, and sparse dispatch switched off
# ---------------------------------------------------------------------------

FIG16_NETS = ("resnet101", "yolov2")
ZOO_VARIANTS = ("two_sided", "weight", "none")
# the profiled networks whose CPU cross-check takes every 3rd layer (the
# card searches every layer), so the phase keeps within its 90 s
ZOO_SAMPLED = ("googlenet", "inception_v3")
P18_NEW = 8
# the CPU cross-checks run in this many worker processes (the card's host
# has 8 cores) while the card searches: the phase's wall is the card's
P18_CPU_WORKERS = 6


def fig16_accelerators():
    """FlexNN (dense) and the two fixed-dataflow baselines scaled to its
    SRAM, built as ``benchmarks/bench_energy_vs_fixed.py`` builds them."""
    from repro_torch.core.energy_model import EYERISS, FLEXNN, TPU
    return {"flex": dataclasses.replace(FLEXNN, sparsity_support="none"),
            "eyeriss": dataclasses.replace(EYERISS,
                                           sram_bytes=FLEXNN.sram_bytes),
            "tpu": dataclasses.replace(TPU, sram_bytes=FLEXNN.sram_bytes,
                                       rf_if=16, rf_fl=32, rf_of=16,
                                       cost_inter_pe=0.12, cost_mac=1.06)}


def same_costs(a, b) -> bool:
    """Two searches' results equal: every layer's winning ``Schedule``,
    and its energy and cycles as floats."""
    return len(a) == len(b) and all(
        x.schedule == y.schedule and x.energy == y.energy
        and x.cycles == y.cycles for x, y in zip(a, b))


def timed_search(layers, acc, sps, device):
    """``optimize_network`` on ``device``: (costs, seconds)."""
    import torch
    from repro_torch.core.scheduler import optimize_network
    t = time.perf_counter()
    costs = optimize_network(layers, acc, sps, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return costs, time.perf_counter() - t


def _cpu_search(layers, acc, sps):
    """``timed_search`` on the CPU in a worker process of phase 18's pool:
    spawned, it finds the package itself, and runs torch on one thread
    beside its siblings."""
    import torch
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    torch.set_num_threads(1)
    return timed_search(layers, acc, sps, "cpu")


def p18_fig16(report, gates, seconds, pool) -> dict:
    """(a) Fig 16: the per-layer optimal flexible schedule against the
    Eyeriss-RS and TPU-NLR baselines, searched on the card and on the
    CPU (in ``pool``'s workers, all submitted before the card starts);
    modelled energies in Table I's units (not joules)."""
    from repro_torch.configs.cnn_zoo import NETWORKS
    accs = fig16_accelerators()
    cpu = {(net, name): pool.submit(_cpu_search, NETWORKS[net](), acc, None)
           for net in FIG16_NETS for name, acc in accs.items()}
    summary = {}
    for net in FIG16_NETS:
        layers = NETWORKS[net]()
        energy = {}
        secs = {"cuda": 0.0, "cpu": 0.0}
        for name, acc in accs.items():
            got, t_cuda = timed_search(layers, acc, None, "cuda")
            want, t_cpu = cpu[(net, name)].result()
            secs["cuda"] += t_cuda
            secs["cpu"] += t_cpu
            ok = same_costs(got, want)
            gates["fig16"] = gates.get("fig16", 0) + ok
            need(ok, f"phase 18: {net} under {name}: the card's search "
                 f"differs from the CPU's")
            energy[name] = [c.energy for c in got]
        seconds[net] = secs
        for base in ("eyeriss", "tpu"):
            red = [100.0 * (1.0 - f / b)
                   for f, b in zip(energy["flex"], energy[base])]
            r = {"network_pct": 100.0 * (1.0 - sum(energy["flex"])
                                         / sum(energy[base])),
                 "min_layer_pct": min(red), "max_layer_pct": max(red),
                 "mean_layer_pct": sum(red) / len(red),
                 "n_negative_layers": sum(v < 0 for v in red),
                 "n_layers": len(red)}
            summary[f"{net}_vs_{base}"] = r
            report(f"Fig 16 {net} vs {base} (modelled energy, Table I "
                   f"units): net={r['network_pct']:.1f}% layers "
                   f"[{r['min_layer_pct']:.1f}, {r['max_layer_pct']:.1f}]% "
                   f"mean={r['mean_layer_pct']:.1f}% "
                   f"neg={r['n_negative_layers']}/{r['n_layers']}")
        report(f"{net}: search {secs['cuda']:.2f} s on the card, "
               f"{secs['cpu']:.2f} s on the CPU (three accelerators, "
               f"{len(layers)} layers each); schedules, energies and "
               f"cycles equal")
    return summary


def p18_zoo(report, gates, seconds, pool) -> dict:
    """(b) The four profiled networks under two-sided, weight-only and no
    sparsity support: the card's search held to the CPU's (in ``pool``'s
    workers, all submitted before the card starts), on every layer of
    resnet50 and mobilenet_v2 and every 3rd (0, 3, 6, ...) of
    ``ZOO_SAMPLED``.  The §V-C profiles are seeded from
    ``hash(network)``, so the energies change from process to process
    (the workers are sent this process's); the gate does not."""
    from repro_torch.configs.cnn_zoo import NETWORKS
    from repro_torch.core.energy_model import flexnn_variant
    from repro_torch.core.sparsity_profiles import (_NETWORK_STATS,
                                                    network_sparsity,
                                                    profiles_for)
    nets = {}
    for net in _NETWORK_STATS:
        layers = NETWORKS[net]()
        nets[net] = (layers, profiles_for(net, layers),
                     3 if net in ZOO_SAMPLED else 1)
    cpu = {(net, v): pool.submit(_cpu_search, layers[::step],
                                 flexnn_variant(v), sps[::step])
           for net, (layers, sps, step) in nets.items()
           for v in ZOO_VARIANTS}
    out = {}
    for net, (layers, sps, step) in nets.items():
        wt_sp, act_sp = network_sparsity(sps, layers)
        secs = {"cuda": 0.0, "cpu": 0.0, "cpu_layers": len(layers[::step])}
        energy = {}
        for v in ZOO_VARIANTS:
            acc = flexnn_variant(v)
            got, t_cuda = timed_search(layers, acc, sps, "cuda")
            want, t_cpu = cpu[(net, v)].result()
            secs["cuda"] += t_cuda
            secs["cpu"] += t_cpu
            ok = same_costs(got[::step], want)
            gates["zoo"] = gates.get("zoo", 0) + ok
            need(ok, f"phase 18: {net} under flexnn-{v}: the card's search "
                 f"differs from the CPU's")
            energy[v] = sum(c.energy for c in got)
        seconds[net] = secs
        out[net] = energy
        report(f"{net} (weight sp {wt_sp:.3f}, act sp {act_sp:.3f}; this "
               f"process's profiles): modelled energy two-sided "
               f"{energy['two_sided']:.4e}, weight-only "
               f"{energy['weight']:.4e}, dense {energy['none']:.4e} "
               f"(Table I units); two-sided saves "
               f"{100 * (1 - energy['two_sided'] / energy['none']):.1f}%; "
               f"search {secs['cuda']:.2f} s card ({len(layers)} layers), "
               f"{secs['cpu']:.2f} s CPU ({secs['cpu_layers']} of them), "
               f"equal")
    return out


def zvc_same(x, report, label, gates) -> tuple:
    """(c) One tensor through the codec on the card and on the CPU:
    decoded equal in value, and packed (bits), bitmap and nnz equal."""
    import torch
    from repro_torch.core.sparsity import zvc_decode, zvc_encode
    packed, bitmap, nnz = zvc_encode(x)
    dec = zvc_decode(packed, bitmap)
    cp, cb, cn = zvc_encode(x.cpu())
    ints = torch.int16 if x.element_size() == 2 else torch.int32
    ok = (torch.equal(dec, x)
          and torch.equal(packed.cpu().view(ints), cp.view(ints))
          and torch.equal(bitmap.cpu(), cb) and int(nnz) == int(cn))
    gates["zvc"] = gates.get("zvc", 0) + ok
    n = x.numel()
    report(f"ZVC {label} {tuple(x.shape)} {x.dtype}: nnz {int(nnz)} of {n} "
           f"({int(nnz) / n:.4f}); decoded == x, and packed / bitmap / nnz "
           f"== the CPU's: {ok}")
    need(ok, f"phase 18: the ZVC codec on {label} differs")
    return bitmap


def p18_zvc(cfg, params, plan, report, gates) -> dict:
    """(c) The codec and the CSB on StableLM-1.6B's tensors: layer 0's
    mlp.in output for one 128-token prompt row block under ReLU (FlexNN's
    ReLU-induced case) and the raw SiLU hidden activation that feeds
    mlp.out (the dense case), and layer 0's pruned mlp.out weight."""
    import torch
    from repro_torch.core.sparsity import (csb_popcount,
                                           relu_activation_bitmap,
                                           zvc_compressed_bytes)
    from repro_torch.models import attention, layers as L, model as M
    from repro_torch.models.transformer import index_tree
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    tokens = torch.randint(0, cfg.vocab, (1, 128), generator=gen,
                           device="cuda")
    p0 = index_tree(params["stack"]["layers"], 0)
    with torch.no_grad():
        x = L.embed(cfg, params["embed"], tokens)
        x = x + attention.attention_forward(
            p0["attn"], cfg, L.apply_norm(p0["ln1"], cfg, x),
            positions=M._positions(tokens))
        h = L.apply_norm(p0["ln2"], cfg, x)[0]
        mm = lambda a, w: torch.matmul(a.float(), w.float()).to(a.dtype)
        pre = mm(h, p0["mlp"]["w_in"])
        relu = torch.relu(pre)
        silu = torch.nn.functional.silu(mm(h, p0["mlp"]["w_gate"])) * pre
    w_out = p0["mlp"]["w_out"]
    a_bm = zvc_same(relu, report, "ReLU(mlp.in output)", gates)
    need(torch.equal(a_bm, relu_activation_bitmap(relu)),
         "phase 18: the ReLU bitmap differs from relu_activation_bitmap")
    zvc_same(silu, report, "SiLU hidden activation", gates)
    w_bm = zvc_same(w_out, report, "pruned mlp.out weight", gates)
    # the MAC pairs that fire for the first rows of relu @ w_out
    pops = []
    for r in range(4):
        got = csb_popcount(a_bm[r][:, None], w_bm)
        want = csb_popcount(a_bm[r].cpu()[:, None], w_bm.cpu())
        need(int(got) == int(want), "phase 18: csb_popcount differs")
        pops.append(int(got))
    gates["csb"] = len(pops)
    k, n = w_out.shape
    report(f"CSB popcount of ReLU rows 0-3 against the pruned mlp.out "
           f"weight: {pops} of {k * n} pairs each (card == CPU)")
    entry = next(e for e in plan.entries.values() if e.site == "mlp.out")
    leaf = params["stack"]["layers"]["mlp"]["w_out"]
    got = zvc_compressed_bytes(leaf, elem_bytes=leaf.element_size())
    want = entry.stats()["zvc_bytes"]
    report(f"mlp.out ZVC bytes, all {leaf.shape[0]} layers: "
           f"zvc_compressed_bytes {got:.1f}, SitePlan.stats {want:.1f}")
    need(got == want, "phase 18: ZVC bytes differ from the plan's")
    gates["zvc_bytes"] = 1
    return {"relu_density": int(a_bm.sum()) / a_bm.numel(),
            "csb_pairs_rows_0_3": pops}


def p18_dispatch(cfg, sp_cfg, params, planned, dense, report,
                 gates) -> dict:
    """(d) ``sparse_dispatch=False`` at full width: the plan's dense
    fallback at every site, through the flex-matmul kernels
    (``use_kernels``, as the reference's switch-off route takes its Pallas
    kernel) at the plan table's schedules; the returned launches are the
    switch-off drain's."""
    import numpy as np
    import torch
    from repro_torch.core.descriptors import site_plan_estimate
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    off = dataclasses.replace(planned, sparse_dispatch=False,
                              use_kernels=True)
    rng = np.random.default_rng(SEED + 18)
    prompts = [rng.integers(0, cfg.vocab, size=8) for _ in range(N_SLOTS)]
    n_sites = sum(e.lead[0] if e.lead else 1
                  for e in planned.plan.entries.values())
    # one decode step under the switch: fm_output at every site, once
    attached = planned.plan.attach(params, verify=False)
    state = M.init_decode_state(cfg, N_SLOTS, 16, dtype=torch.bfloat16,
                                device="cuda")
    tok = torch.zeros((N_SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.zeros((N_SLOTS,), dtype=torch.long, device="cuda")
    live = torch.ones((N_SLOTS,), dtype=torch.bool, device="cuda")
    reset_launches()
    with torch.no_grad(), ops.exec_config(off):
        M.masked_decode_step(attached, cfg, tok, state, pos, live)
    torch.cuda.synchronize()
    step = launch_counts()
    report(f"one decode step, sparse_dispatch=False: fm_output "
           f"{step['output']} launches ({n_sites} sites x layers), "
           f"bs_matmul {step['block_sparse']}")
    need(step["output"] == n_sites and step["block_sparse"] == 0,
         "phase 18: the switch-off step did not run fm_output once at "
         "every site")
    del attached, state
    streams, launches = {}, {}
    for label, ec in (("sparse_dispatch=False", off), ("plan", planned)):
        reset_launches()
        eng = make_engine(cfg, params, ec, True)
        uids = [eng.submit(p, max_new=P18_NEW) for p in prompts]
        res = eng.run_until_drained()
        torch.cuda.synchronize()
        streams[label] = [res[u] for u in uids]
        launches[label] = {k: launch_counts()[k] for k in
                           ("block_sparse", "output")}
        report(f"drain ({label}): {N_SLOTS} x 8 prompt tokens x {P18_NEW} "
               f"new; launches {launches[label]}")
    off_counts = launches["sparse_dispatch=False"]
    need(off_counts["block_sparse"] == 0 and off_counts["output"] > 0,
         "phase 18: the switch-off drain launched bs_matmul")
    same = streams["sparse_dispatch=False"] == streams["plan"]
    report(f"switch-off streams == plan streams: {same}")
    need(same, "phase 18: the switch-off streams differ from the plan's")
    gates["dispatch_streams"] = 1
    # four step()s' logits under the three tables, bit for bit
    logits = {}
    for label, ec in (("sparse_dispatch=False", off), ("plan", planned),
                      ("dense table", dense)):
        eng = make_engine(cfg, params, ec, False)
        for p in prompts:
            eng.submit(p, max_new=P18_NEW)
        steps = []
        for _ in range(4):
            eng.step()
            steps.append(eng.last_logits.clone())
        logits[label] = torch.stack(steps)
    base = logits["sparse_dispatch=False"]
    for label in ("plan", "dense table"):
        ok = torch.equal(base, logits[label])
        report(f"four step()s' logits, sparse_dispatch=False == {label} "
               f"bit for bit: {ok}")
        need(ok, f"phase 18: switch-off logits differ from the {label}'s")
        gates["dispatch_logits"] = gates.get("dispatch_logits", 0) + 1
    need(bool(torch.isfinite(base).all()), "phase 18: non-finite logits")
    # the plan estimate beside what the plan measured
    for e in planned.plan.entries.values():
        d = planned.schedules.sites[e.site]
        est = site_plan_estimate(d, sp_cfg)
        st = e.stats()
        n_l = st["layers"]
        report(f"  {e.site}: est_max_nnz {est['est_max_nnz']} vs max_nnz "
               f"{st['max_nnz']} (tk {st['tk']}); ZVC bytes est "
               f"{est['zvc_bytes'] * n_l:.4e} vs measured "
               f"{st['zvc_bytes']:.4e} ({n_l} layers)")
    return off_counts


def run_analytic(report) -> tuple:
    """Phase 18 (a)-(d).  Returns the switch-off drain's launches and the
    ``analytic`` JSON object."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    t0 = time.perf_counter()
    gates, seconds = {}, {}
    with ProcessPoolExecutor(
            P18_CPU_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        fig16 = p18_fig16(report, gates, seconds, pool)
        zoo = p18_zoo(report, gates, seconds, pool)
    t_search = time.perf_counter() - t0
    cfg, sp_cfg, params, planned, dense = bring_up(report)
    zvc = p18_zvc(cfg, params, planned.plan, report, gates)
    launches = p18_dispatch(cfg, sp_cfg, params, planned, dense, report,
                            gates)
    del params, planned, dense
    free()
    secs = time.perf_counter() - t0
    report(f"phase 18 wall time: {secs:.1f} s (searches {t_search:.1f} s; "
           f"budget 90 s)")
    return launches, {"seconds": secs, "search_seconds": t_search,
                      "search_seconds_by_network": seconds,
                      "fig16_modelled_energy": fig16,
                      "zoo_modelled_energy": zoo, "zvc": zvc,
                      "gates": gates, "device": torch.cuda.get_device_name(0)}


# ---------------------------------------------------------------------------
# phases 19-20: the SSM family (Mamba-2) and the Whisper encoder-decoder
# ---------------------------------------------------------------------------

P19_ARCH = "mamba2-1.3b"
P19_NEW = 8           # 16 up to PR 24: host-paced, it sets phase 19's wall
# the prefill cells: 2 x 4096 tokens (the dense family's) and one prompt of
# 32768 (the reference's long_500k shape cut to 32768: PERF.md section 4)
P19_PREFILLS = ((2, 4096), (1, 32768))
P19_STEP_TOKENS = 256      # gate (b)'s chunk-1 recurrence, 2 prompts
P20_ARCH = "whisper-tiny"
# Whisper's window: 30 s of audio is 1500 encoder frames, and its decoder
# context 448 tokens
P20_FRAMES, P20_TOKENS = 1500, 448
U_BF16, U_F32 = 2.0 ** -8, 2.0 ** -24     # unit roundoffs
# bf16 roundings in series on the SSD's longest path: the in-projection,
# the four conv taps and their sum, the silu, the chunk scores, the chunk
# weights, the intra- and inter-chunk products, the chunk states, the
# sum, the D skip, the gated norm, the out-projection (PERF.md section 6)
SSD_BF16_ROUNDINGS = 16


def _drain(eng, prompts, max_new):
    uids = [eng.submit(p, max_new=max_new) for p in prompts]
    res = eng.run_until_drained()
    return [res[u] for u in uids]


def p19_bring_up(report):
    """mamba2-1.3b at its published width and depth: bf16 weights from
    seed 0 (not pruned: no plan reaches an SSM site), the sparse config's
    exec config (its plan is empty, so None) and the dense table."""
    import torch
    from repro_torch.configs import SparsityConfig, get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.ssm import d_inner, n_ssd_heads
    from repro_torch.serve.engine import decode_exec_config
    cfg = get_config(P19_ARCH)
    sp_cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
        weight_sparsity=0.5, activation_threshold=0.05))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    planned = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                 use_kernels=True, device="cuda")
    dense = decode_exec_config(cfg, N_SLOTS, use_kernels=True, device="cuda")
    need(planned.plan is None, f"{P19_ARCH}: the sparse config compiled a "
         f"plan, but no SSM site is plannable and the tied head never is")
    n_params = sum(t.numel() for _, t in _leaves(params))
    h, s = n_ssd_heads(cfg), cfg.ssm
    ssm_mb = cfg.n_layers * h * s.head_dim * s.d_state * 4 / 1e6
    conv_mb = cfg.n_layers * (s.d_conv - 1) * (
        d_inner(cfg) + 2 * s.n_groups * s.d_state) * 4 / 1e6
    report(f"{P19_ARCH}: {cfg.n_layers} SSD layers, d {cfg.d_model}, "
           f"d_inner {d_inner(cfg)}, {h} SSD heads of {s.head_dim}, d_state "
           f"{s.d_state}, conv {s.d_conv}, chunk {s.chunk}, vocab "
           f"{cfg.vocab}, tied head {cfg.tie_embeddings}; "
           f"{n_params / 1e9:.3f} B parameters, init {t_init:.1f} s; decode "
           f"state per slot {ssm_mb:.1f} MB (SSD) + {conv_mb:.1f} MB (conv "
           f"window), float32; the sparse config's plan: none (no plannable "
           f"site)")
    report(dense.schedules.describe())
    return cfg, sp_cfg, params, planned, dense


def p19_ssd(cfg, params, report) -> None:
    """Gate (b).  Layer 0's ``ssd_forward`` on the card at 2 x 4096, on the
    input the path gives it (the normed embeddings of seeded tokens), in
    bf16 and in float32 (TF32 off), against the same function evaluated in
    float64 on the CPU (float64 wherever the function does not pin float32
    itself: its dt, chunk states and gated norm are float32 as written).

    The reference's intra-chunk mask keeps the decays of later tokens,
    exp of sums of |dt·A| over up to a chunk (exponents near 100 here), so
    pre-norm outputs reach ~1e30 and the gated norm's float32 sum of
    squares overflows: those rows come out zero, in the reference's
    function as in every evaluation of it.  A row whose float64 sum of
    squares lies within an evaluation's error band of the float32 maximum
    may fall either way; such rows are counted and left out of that
    evaluation's gate.  The bounds, relative to the output's scale
    s = max|y64|:

    - a rounding of the raw dt by a relative r moves dt = softplus(raw +
      b) by sigmoid(raw + b)·r·|raw|, so a decay's exponent by up to
      r·E, E = max over (row, chunk, head) of |A|·Σ sigmoid(raw + b)·|raw|
      over the chunk, and the output by expm1(r·E)·s;
    - bf16 (r = u16 = 2⁻⁸, the in-projection's output rounding), plus
      ``SSD_BF16_ROUNDINGS`` roundings of u16 in series, first order:
      tol16 = (expm1(u16·E) + 16·u16)·s;
    - float32: r = √d·u32 (a float32 dot product over d terms, the form of
      ``matmul_tol``), plus the sums in series (in_proj over d, the two
      chunk sums, the inter-chunk sum over d_state, out_proj over
      d_inner) each √K·u32 and 16 roundings: tol32 = (expm1(√d·u32·E) +
      (Σ√K + 16)·u32)·s.  Its control, the same float32 call with TF32
      allowed, must exceed tol32.

    Then chunk 1 against the stepwise recurrence (``ssd_decode_step``
    token by token) in float32 on 2 x 256 tokens, within the reference's
    1e-5 (rtol = atol)."""
    import math
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm, embed
    from repro_torch.models.transformer import index_tree
    lp = index_tree(params["stack"]["layers"], 0)
    b, s = P19_PREFILLS[0]
    toks = torch.as_tensor(np.random.default_rng(19).integers(
        0, cfg.vocab, size=(b, s)), device="cuda")
    p16 = lp["ssm"]
    p32 = {k: v.float() for k, v in p16.items()}
    prenorm = []
    norm = ssm._gated_norm

    def spy(y, z, scale, *tp):      # the float64 evaluation's norm input
        prenorm.append(((y.double() * F.silu(z.double())) ** 2).sum(-1))
        return norm(y, z, scale, *tp)
    with torch.no_grad():
        x = apply_norm(lp["ln1"], cfg, embed(cfg, params["embed"], toks))
        ssm.ssd_forward(cfg, p16, x)
        out16, t16 = _timed(lambda: ssm.ssd_forward(cfg, p16, x))
        out32 = ssm.ssd_forward(cfg, p32, x.float())
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out_tf32 = ssm.ssd_forward(cfg, p32, x.float())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        p64 = {k: v.double().cpu() for k, v in p16.items()}
        x64 = x.double().cpu()
        ssm._gated_norm = spy
        try:
            out64 = ssm.ssd_forward(cfg, p64, x64)
        finally:
            ssm._gated_norm = norm
        h = ssm.n_ssd_heads(cfg)
        raw = x64 @ p64["in_proj"][:, -h:]
        sens = torch.sigmoid(raw + p64["dt_bias"]) * raw.abs() \
            * torch.exp(p64["A_log"])
        chunk = min(cfg.ssm.chunk, s)
        e_sum = sens.reshape(b, s // chunk, chunk, h).sum(2).max().item()
        t64 = time.perf_counter() - t0
    scale = out64.abs().max().item()
    sqrt_k = sum(math.sqrt(k) for k in (
        cfg.d_model, chunk, chunk, cfg.ssm.d_state, ssm.d_inner(cfg)))
    rel16 = math.expm1(U_BF16 * e_sum) + SSD_BF16_ROUNDINGS * U_BF16
    rel32 = math.expm1(math.sqrt(cfg.d_model) * U_F32 * e_sum) \
        + (sqrt_k + 16) * U_F32
    sumsq = prenorm[0]
    fmax = torch.finfo(torch.float32).max
    zeroed = int((sumsq >= fmax).sum())
    row_err = {}
    for name, out in (("bf16", out16), ("float32", out32),
                      ("TF32", out_tf32)):
        row_err[name] = (out.double().cpu() - out64).abs().amax(-1)

    def gate(name, rel):
        band = (sumsq > fmax / (1 + rel) ** 2) & (sumsq < fmax
                                                  * (1 + rel) ** 2)
        return row_err[name][~band].max().item(), int(band.sum())
    e16, band16 = gate("bf16", rel16)
    e32, band32 = gate("float32", rel32)
    etf, _ = gate("TF32", rel32)
    tol16, tol32 = rel16 * scale, rel32 * scale
    finite = bool(torch.isfinite(out16).all()) and out16.shape == x.shape
    report(f"{P19_ARCH} layer 0 ssd_forward at {b} x {s} (chunk {chunk}): "
           f"bf16 {t16 * 1e3:.2f} ms on the card; vs float64 on the CPU "
           f"({t64:.1f} s): max |y64| {scale:.4e}, exponent sensitivity E "
           f"{e_sum:.2f}; rows the float32 norm zeroes (sum of squares past "
           f"the float32 maximum) {zeroed} of {b * s}, rows in the error "
           f"band bf16 {band16}, float32 {band32}; outside the bands: bf16 "
           f"max err {e16:.4e} (tol {tol16:.4e}), float32 {e32:.4e} (tol "
           f"{tol32:.4e}), TF32 control {etf:.4e} (must exceed the float32 "
           f"tol); in all rows bf16 {row_err['bf16'].max().item():.4e}, "
           f"float32 {row_err['float32'].max().item():.4e}")
    need(finite, f"{P19_ARCH}: layer 0's bf16 SSD is not finite")
    need(e16 <= tol16, f"{P19_ARCH}: bf16 SSD error {e16} > {tol16}")
    need(e32 <= tol32, f"{P19_ARCH}: float32 SSD error {e32} > {tol32}")
    need(etf > tol32, f"{P19_ARCH}: the float32 SSD bound does not reject "
         f"TF32 ({etf} <= {tol32})")
    del out16, out32, out_tf32, out64, x64, raw, sens, prenorm
    p19_ssd_tail(cfg, x, p16, p32, p64, report)
    del p64
    # chunk 1 is the recurrence
    cfg1 = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                            chunk=1))
    xs = x[:, :P19_STEP_TOKENS].float()
    with torch.no_grad():
        full = ssm.ssd_forward(cfg1, p32, xs)
        st = ssm.init_ssm_state(cfg1, b, device="cuda")
        steps = []
        for t in range(xs.shape[1]):
            y, st = ssm.ssd_decode_step(cfg1, p32, xs[:, t:t + 1], st)
            steps.append(y)
        steps = torch.cat(steps, 1)
    gap = ((full - steps).abs() - 1e-5 * steps.abs()).max().item()
    report(f"{P19_ARCH} layer 0, chunk 1, float32, {b} x "
           f"{P19_STEP_TOKENS}: chunked form vs the stepwise recurrence "
           f"max |diff| {(full - steps).abs().max().item():.3e} (bound "
           f"1e-5 + 1e-5·|y|)")
    need(gap <= 1e-5, f"{P19_ARCH}: chunk 1 differs from the recurrence")
    free()


def _ssd_cumsum(fn, replay=None):
    """``fn()`` with the SSD's one ``torch.cumsum`` (the decay exponents
    dA_cum) recorded, or replaced by ``replay``: (fn(), dA_cum)."""
    import torch
    real, seen = torch.cumsum, []

    def hook(t, *args, **kw):
        out = real(t, *args, **kw) if replay is None else replay.to(
            t.device, torch.promote_types(t.dtype, replay.dtype))
        seen.append(out)
        return out
    torch.cumsum = hook
    try:
        out = fn()
    finally:
        torch.cumsum = real
    need(len(seen) == 1, f"the SSD took {len(seen)} cumsums, not one")
    return out, seen[0]


def _ssd_f64(cfg, p64, zx, cum):
    """``ssd_from_proj`` in float64 on the CPU from the projection ``zx``
    and the decay exponents ``cum``, with each row's sum of squares at its
    gated norm."""
    import torch.nn.functional as F
    from repro_torch.models import ssm
    norm, sumsq = ssm._gated_norm, []

    def spy(y, z, scale, *tp):
        sumsq.append(((y * F.silu(z)) ** 2).sum(-1))
        return norm(y, z, scale, *tp)
    ssm._gated_norm = spy
    try:
        out, _ = _ssd_cumsum(lambda: ssm.ssd_from_proj(
            cfg, p64, zx.double().cpu()), replay=cum.double().cpu())
    finally:
        ssm._gated_norm = norm
    return out, sumsq[0]


def p19_ssd_tail(cfg, x, p16, p32, p64, report) -> None:
    """Gate (b) after the in-projection: ``ssd_from_proj`` on the card fed
    the projection the card computed, in float32 (TF32 off) and in bf16,
    against float64 on the CPU fed the same projection.  The
    in-projection's rounding of dt, which the decays' exponents amplify
    (``p19_ssd``), drops out.  So does the float32 rounding of the
    exponents themselves (a cumsum over the chunk of dt·A, up to ~80
    here), which moves every decay alike: the exponents are checked on
    their own, and the float64 evaluation replays the card's.

    - exponents: max |dA_cum - dA_cum64| <= (chunk - 1)·u32·max|dA_cum64|,
      the bound of a sum of same-signed terms in any order.
    - float32: tol = (Σ√K + 16)·u32·s, K the tail's sums (the two chunk
      sums, d_state, d_inner), s = max|y64|, over the rows outside the
      norm's overflow band.  It must reject the same call with TF32
      allowed, and the same call with the inter-chunk term (``y_inter``)
      dropped: at these inputs that term moves the output by less than
      one bf16 rounding, so only a float32 bound sees it.
    - bf16: on the last token of each chunk, whose intra-chunk term is its
      own (the mask keeps j >= i) and whose decays are all exps of sums
      <= 0: tol = (SSD_BF16_ROUNDINGS - 1)·u16·s_last, the roundings in
      series after the in-projection, at condition 1."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssm
    b, s = x.shape[:2]
    h, chunk = ssm.n_ssd_heads(cfg), min(cfg.ssm.chunk, s)
    real_einsum = torch.einsum

    def no_inter(eq, *ops):     # the inter-chunk output term, dropped
        out = real_einsum(eq, *ops)
        return torch.zeros_like(out) if eq == "bnchx,bnhpx,bnch->bnchp" \
            else out
    with torch.no_grad():
        zx32 = torch.matmul(x.float(), p32["in_proj"])
        t32, cum32 = _ssd_cumsum(lambda: ssm.ssd_from_proj(cfg, p32, zx32))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            t_tf32 = ssm.ssd_from_proj(cfg, p32, zx32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        torch.einsum = no_inter
        try:
            t_noint = ssm.ssd_from_proj(cfg, p32, zx32)
        finally:
            torch.einsum = real_einsum
        ref32, sumsq = _ssd_f64(cfg, p64, zx32, cum32)
        dt64 = F.softplus(zx32[..., -h:].cpu().double() + p64["dt_bias"])
        cum64 = torch.cumsum((dt64 * -torch.exp(p64["A_log"])).reshape(
            b, s // chunk, chunk, h), dim=2)
        zx16 = torch.matmul(x, p16["in_proj"])
        t16, cum16 = _ssd_cumsum(lambda: ssm.ssd_from_proj(cfg, p16, zx16))
        ref16, _ = _ssd_f64(cfg, p64, zx16, cum16)
    exp_err = (cum32.double().cpu() - cum64).abs().max().item()
    exp_max = cum64.abs().max().item()
    exp_tol = (chunk - 1) * U_F32 * exp_max
    scale = ref32.abs().max().item()
    rel32 = (sum(math.sqrt(k) for k in (chunk, chunk, cfg.ssm.d_state,
                                        ssm.d_inner(cfg))) + 16) * U_F32
    fmax = torch.finfo(torch.float32).max
    band = (sumsq > fmax / (1 + rel32) ** 2) & (sumsq < fmax
                                                * (1 + rel32) ** 2)

    def err(out, ref, rows):
        return (out.double().cpu() - ref).abs().amax(-1)[rows].max().item()
    e32, etf, eni = (err(o, ref32, ~band) for o in (t32, t_tf32, t_noint))
    tol32 = rel32 * scale
    last = torch.zeros(b, s, dtype=torch.bool)
    last[:, chunk - 1::chunk] = True
    scale16 = ref16[last].abs().max().item()
    e16 = err(t16, ref16, last)
    tol16 = (SSD_BF16_ROUNDINGS - 1) * U_BF16 * scale16
    report(f"{P19_ARCH} layer 0 SSD after the in-projection (fed the card's "
           f"projection; float64 on the CPU fed the same): decay exponents "
           f"max err {exp_err:.4e} (tol {exp_tol:.4e}, max |dA_cum| "
           f"{exp_max:.2f}); with the card's exponents replayed, float32 "
           f"max err {e32:.4e} (tol {tol32:.4e}, max |y64| {scale:.4e}, rows "
           f"in the norm's band {int(band.sum())}); controls it must reject: "
           f"TF32 {etf:.4e}, inter-chunk term dropped {eni:.4e}; bf16 on the "
           f"{int(last.sum())} chunk-end rows max err {e16:.4e} (tol "
           f"{tol16:.4e}, max |y64| there {scale16:.4e})")
    need(exp_err <= exp_tol, f"{P19_ARCH}: SSD decay exponents off by "
         f"{exp_err} > {exp_tol}")
    need(e32 <= tol32, f"{P19_ARCH}: float32 SSD tail error {e32} > {tol32}")
    need(etf > tol32 and eni > tol32, f"{P19_ARCH}: the float32 SSD tail "
         f"bound does not reject TF32 ({etf}) or a dropped inter-chunk term "
         f"({eni}) at tol {tol32}")
    need(e16 <= tol16, f"{P19_ARCH}: bf16 SSD chunk-end error {e16} > "
         f"{tol16}")


def p19_profile(eng, report, label) -> None:
    """One profiled ``step()`` of an engine (its first decode step after
    admission): device busy share, by kernel family, the top device
    operations; then its model call by ``device_ms``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy, n_kernels, fam = device_breakdown(prof)
    top = device_tops(prof, 8)
    if not busy:
        report(f"profiled {label} decode step: the profiler recorded no "
               "device time (not measured)")
    else:
        report(f"profiled {label} decode step: wall {wall * 1e3:.2f} ms, "
               f"device busy {busy / 1e3:.2f} ms "
               f"({100 * busy / 1e3 / (wall * 1e3):.1f}% of wall, "
               f"{n_kernels} kernels); by family {fam}; top device "
               f"operations {[(n[:60], round(us / 1e3, 3), c) for n, (us, c) in top]}")
    p15_step_device(eng, report, round(busy / 1e3, 3) if busy else None,
                    label=label)


def p19_serve(cfg, params, planned, dense, report, card) -> None:
    """Gate (c): the decode gates (``family_serve``: fused == ``step()``,
    the sparse config's logits == the dense table's bit for bit), chunked
    admission at 4 and 8 tokens, async dispatch, a reused slot and the
    plain route, all on the same 4 greedy requests."""
    prompts = family_prompts(cfg, seed=19)
    _, streams, logits_p = family_serve(
        cfg, params, planned, dense, report, card, prompts=prompts,
        max_new=P19_NEW, on_oracle=lambda o: p19_profile(o, report,
                                                         cfg.name))
    for chunk in (4, 8):
        got = _drain(family_engine(cfg, params, planned, max_new=P19_NEW,
                                   prefill_chunk=chunk), prompts, P19_NEW)
        report(f"{cfg.name}: prefill_chunk {chunk} streams == whole-prompt "
               f"admission: {got == streams}")
        need(got == streams, f"{cfg.name}: chunked admission ({chunk}) "
             f"changed the streams")
        free()
    eng = family_engine(cfg, params, planned, max_new=P19_NEW,
                        async_dispatch=True)
    got, wall, timing = drain_timed(eng, prompts, P19_NEW)
    report(f"{cfg.name} async dispatch: {rate_line(got, wall, timing)}; "
           f"streams == sync: {got == streams} ({card})")
    need(got == streams, f"{cfg.name}: async dispatch changed the streams")
    del eng
    free()
    # a slot reused by a second request starts from a zero state: the
    # second request's stream equals its stream in a fresh 1-slot engine
    # (the same row count, so the same matmul kernels and bits)
    one = family_engine(cfg, params, planned, max_new=P19_NEW, n_slots=1)
    _, second = _drain(one, prompts[:2], P19_NEW)
    fresh = family_engine(cfg, params, planned, max_new=P19_NEW, n_slots=1)
    alone = _drain(fresh, prompts[1:2], P19_NEW)[0]
    report(f"{cfg.name}: a reused slot's stream == the request's stream in "
           f"a fresh 1-slot engine: {second == alone}; (not a gate) its "
           f"stream beside three others in the 4-slot engine == alone: "
           f"{streams[1] == alone}")
    need(second == alone, f"{cfg.name}: a reused slot carried state into "
         f"the next request")
    del one, fresh
    free()
    family_plain(cfg, params, prompts, logits_p, report)


def p19_overflow(cfg, params, tokens, report):
    """Where a full-width chunked prefill goes non-finite: the stack layer
    by layer on ``tokens``, with each layer's largest intra-chunk decay
    exponent (Σ|dt·A| over a chunk's later tokens, which the reference's
    mask keeps; float32's exp overflows above log(FLT_MAX) = 88.72).
    Returns the number of layers whose outputs are all finite."""
    import math
    import torch
    import torch.nn.functional as F
    from repro_torch.models import ssm
    from repro_torch.models.layers import apply_norm, embed
    from repro_torch.models.transformer import index_tree
    b, s = tokens.shape
    h, chunk = ssm.n_ssd_heads(cfg), min(cfg.ssm.chunk, s)
    first, worst = None, 0.0
    with torch.no_grad():
        x = embed(cfg, params["embed"], tokens)
        for i in range(cfg.n_layers):
            lp = index_tree(params["stack"]["layers"], i)
            y = apply_norm(lp["ln1"], cfg, x)
            raw = torch.matmul(y, lp["ssm"]["in_proj"])[..., -h:]
            da = F.softplus(raw.float() + lp["ssm"]["dt_bias"]) \
                * torch.exp(lp["ssm"]["A_log"])
            ex = da.reshape(b, s // chunk, chunk, h)[:, :, 1:].sum(2) \
                .max().item()
            worst = max(worst, ex)
            x = x + ssm.ssd_forward(cfg, lp["ssm"], y)
            if first is None and not bool(torch.isfinite(x).all()):
                first = (i, ex, int((~torch.isfinite(x)).any(-1).sum()))
    where = ("every layer's output finite" if first is None else
             f"first non-finite output at layer {first[0]} (largest decay "
             f"exponent there {first[1]:.2f}; {first[2]} of {b * s} "
             f"positions non-finite)")
    report(f"{cfg.name} {b} x {s} chunked prefill, layer by layer: {where}; "
           f"largest decay exponent over the layers {worst:.2f} (float32 "
           f"exp overflows above {math.log(torch.finfo(torch.float32).max):.2f})")
    return cfg.n_layers if first is None else first[0]


def p19_prefill(cfg, params, report, card) -> None:
    """Gate (d): ``model.prefill`` under the dense prefill table at 2 x 4096
    and 1 x 32768 tokens (the second call of each timed, the first warms):
    ms per prompt token, one profiled call, peak memory.  At full width the
    reference's chunked SSD overflows float32 (its mask keeps the decays
    of later tokens), so the full stack's logits are gated on their shape
    only; ``p19_overflow`` finds the first layer with a non-finite output,
    and the prefill cut to the layers before it (the same tokens, finite
    logits required) is held against the plain path within 5% of max
    |logit|."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config
    for b, s in P19_PREFILLS:
        pf = shape_exec_config(cfg, ShapeConfig(f"p19_{s}", "prefill", s, b),
                               use_kernels=True, device="cuda")
        batch = {"tokens": torch.as_tensor(np.random.default_rng(s).integers(
            0, cfg.vocab, size=(b, s)), device="cuda")}

        def call(ec=pf, c=cfg):
            return _under(ec, lambda: model_lib.prefill(params, c, batch))
        torch.cuda.reset_peak_memory_stats()
        call()
        logits, wall = _timed(call)
        ok = torch.isfinite(logits).all(-1)[:, 0]
        need(logits.shape == (b, 1, cfg.vocab),
             f"{cfg.name}: prefill logits of shape {tuple(logits.shape)}")
        report(f"{cfg.name} bf16 prefill {b} x {s}, dense table: {wall:.3f} "
               f"s = {1e3 * wall / (b * s):.5f} ms per prompt token; rows "
               f"with finite logits {int(ok.sum())} of {b}; peak "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
        profile_prefill(call, report, f"{cfg.name} bf16 prefill {b} x {s} "
                        f"(dense table)")
        del logits
        depth = p19_overflow(cfg, params, batch["tokens"], report)
        need(depth > 0, f"{cfg.name}: layer 0's prefill output is not finite")
        cut = dataclasses.replace(cfg, n_layers=depth)
        got, plain = call(c=cut), call(None, cut)
        ok = torch.isfinite(got).all(-1)[:, 0]
        same_rows = torch.equal(torch.isfinite(plain).all(-1)[:, 0], ok)
        diff = tol = float("nan")
        if bool(ok.any()):
            diff = (plain[ok] - got[ok]).abs().max().item()
            tol = 0.05 * got[ok].abs().max().item()
        report(f"{cfg.name} bf16 prefill {b} x {s} cut to its {depth} finite "
               f"layer(s): rows with finite logits {int(ok.sum())} of {b}, "
               f"the plain path's the same {same_rows}; vs the dense table "
               f"max |diff| {diff:.3e}, tol {tol:.3e}")
        need(bool(ok.any()) and same_rows and diff <= tol,
             f"{cfg.name}: the {depth}-layer prefill's plain path differs "
             f"from the dense table's ({int(ok.sum())} finite rows, "
             f"{same_rows}, {diff} > {tol})")
        del got, plain, pf, batch
        free()


def p19_int8(cfg, params, report) -> None:
    """Gate (e): ``quantize=True`` refuses an SSM stack (the reference's
    bare products cannot take its QuantizedLinear leaves)."""
    try:
        family_engine(cfg, params, None, quantize=True)
    except NotImplementedError as exc:
        report(f"{cfg.name} quantize=True raises NotImplementedError: {exc}")
    else:
        need(False, f"{cfg.name}: quantize=True served an SSM stack")


def run_ssm(report, card):
    """Phase 19.  Returns its main-path launches and the tied head's
    worst error."""
    import torch
    t0 = time.perf_counter()
    cfg, _, params, planned, dense = p19_bring_up(report)
    err = check_tied_head(params, dense, report)
    p19_ssd(cfg, params, report)
    reset_launches()
    p19_serve(cfg, params, planned, dense, report, card)
    p19_prefill(cfg, params, report, card)
    p19_int8(cfg, params, report)
    torch.cuda.synchronize()
    launches = launch_counts()
    report(f"main-path launches (phase 19): {launches}")
    need(launches["output"] > 0, "fm_output never launched in phase 19")
    report(f"phase 19 peak memory: max_memory_allocated "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall "
           f"{time.perf_counter() - t0:.1f} s ({card})")
    del params, planned, dense
    free()
    return launches, err


def p20_forward(cfg, sp_cfg, params, report, card) -> None:
    """``forward_hidden`` and ``prefill`` (the encoder pass) on Whisper's
    window (2 x 1500 frames, 2 x 448 decoder tokens) under the dense
    prefill table, the planned prefill plan (equal bit for bit) and the
    plain path (within 5% of the largest magnitude)."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config
    b = 2
    shape = ShapeConfig("p20", "prefill", P20_TOKENS, b)
    dense_pf = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
    planned_pf = shape_exec_config(sp_cfg, shape, use_kernels=True,
                                   params=params, device="cuda")
    attached = planned_pf.plan.attach(params)
    rng = np.random.default_rng(20)
    batch = {"tokens": torch.as_tensor(rng.integers(
                 0, cfg.vocab, size=(b, P20_TOKENS)), device="cuda"),
             "frames": torch.as_tensor(rng.normal(size=(
                 b, P20_FRAMES, cfg.d_model)).astype(np.float32),
                 device="cuda").to(torch.bfloat16)}
    for fn in ("forward_hidden", "prefill"):
        def call(ec, p):
            return _under(ec, lambda: getattr(model_lib, fn)(p, cfg, batch))
        call(dense_pf, params)
        out, wall = _timed(lambda: call(dense_pf, params))
        want = (b, P20_TOKENS if fn == "forward_hidden" else 1, cfg.d_model)
        need(bool(torch.isfinite(out).all()) and tuple(out.shape) == want,
             f"{cfg.name}: bad {fn} output")
        out_p, wall_p = _timed(lambda: call(planned_pf, attached))
        out_0 = call(None, params)
        same = torch.equal(out_p, out)
        diff = (out_0.float() - out.float()).abs().max().item()
        tol = 0.05 * out.float().abs().max().item()
        report(f"{cfg.name} bf16 {fn} ({b} x {P20_FRAMES} frames, {b} x "
               f"{P20_TOKENS} tokens): dense table {wall * 1e3:.2f} ms, "
               f"planned {wall_p * 1e3:.2f} ms, equal bit for bit {same}; "
               f"plain max |diff| {diff:.3e}, tol {tol:.3e} ({card})")
        need(same, f"{cfg.name}: planned {fn} differs from the dense table")
        need(diff <= tol, f"{cfg.name}: plain {fn} off by {diff}")
        if fn == "forward_hidden":
            profile_prefill(lambda: call(dense_pf, params), report,
                            f"{cfg.name} bf16 forward_hidden (dense table)")
    del dense_pf, planned_pf, attached
    free()


def p20_int8(cfg, sp_cfg, params, report, card) -> dict:
    """int8 where the reference serves it: unplanned ``quantize=True``
    raises; under the int8 plan bf16 weights raise too (the cross-
    attention's bare products meet float32 dequantized weights and the
    residual stream changes dtype, which the reference's scan refuses);
    float32 weights and state serve: the int8 kernels against their plain
    versions at layer 0's sites (``check_sites_int8``, not counted), the
    planned int8 engine's fused streams equal its ``step()`` oracle's.
    Returns the int8 kernels' worst errors."""
    import torch
    from repro_torch.serve.engine import decode_exec_config
    try:
        family_engine(cfg, params, None, quantize=True)
    except NotImplementedError as exc:
        report(f"{cfg.name} unplanned quantize=True raises "
               f"NotImplementedError: {exc}")
    else:
        need(False, f"{cfg.name}: unplanned int8 served")
    q8 = decode_exec_config(sp_cfg, N_SLOTS, params=params, quantize=True,
                            use_kernels=True, device="cuda")
    eng = family_engine(cfg, params, q8)
    eng.submit(family_prompts(cfg)[0], max_new=2)
    try:
        eng.run_until_drained()
    except TypeError as exc:
        report(f"{cfg.name} planned int8 with bf16 weights raises "
               f"TypeError: {exc}")
    else:
        need(False, f"{cfg.name}: planned int8 served bf16 weights, where "
             f"the reference's scan refuses the carry")
    del eng, q8
    free()
    params32 = {}
    for path, leaf in _leaves(params):
        d = params32
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = leaf.float()
    q8 = decode_exec_config(sp_cfg, N_SLOTS, params=params32, quantize=True,
                            use_kernels=True, device="cuda")
    saved = launch_counts()
    errs = check_sites_int8(cfg, params32, q8, report)["errs"]
    reset_launches(saved)
    free()
    family_serve(cfg, params32, q8, None, report, card,
                 label="int8 (float32 weights and state)",
                 dtype=torch.float32)
    del params32, q8
    free()
    return errs


def run_whisper(report, card):
    """Phase 20.  Returns its main-path launches and the kernels' worst
    errors at its sites."""
    import torch
    t0 = time.perf_counter()
    cfg, sp_cfg, params, planned, dense = family_bring_up(P20_ARCH, report)
    report(f"{P20_ARCH}: the matmul kernels vs their plain versions at "
           f"encoder and decoder layer 0's sites, cross-attention included")
    errs = check_sites(params, planned, dense, report)["errs"]
    free()
    reset_launches()
    p20_forward(cfg, sp_cfg, params, report, card)
    family_serve(cfg, params, planned, dense, report, card)
    errs.update(p20_int8(cfg, sp_cfg, params, report, card))
    torch.cuda.synchronize()
    launches = launch_counts()
    report(f"main-path launches (phase 20): {launches}")
    for name in ("block_sparse", "output", "block_sparse_scaled"):
        need(launches[name] > 0, f"kernel {name} never launched in phase 20")
    report(f"phase 20 peak memory: max_memory_allocated "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; wall "
           f"{time.perf_counter() - t0:.1f} s ({card})")
    del params, planned, dense
    free()
    report(f"{P20_ARCH} matmul kernels' worst errors: {errs}")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 21: training — gradients through the kernels, fa_backward, the train
# step at full width, resume, and the published 24 layers through the
# launcher's path
# ---------------------------------------------------------------------------

P21_SEQ = 4096         # StableLM-1.6B's context; above the flash threshold
P21_BATCH = 4          # train_4k's global batch (256) cut to 4
P21_MICRO = 2          # microbatches of 2 x 4096: M = 8192 rows per site
P21_FIXED_STEPS = 4
P21_PIPE_STEPS = 2
P21_MIN_FALL = 0.05    # nats the fixed-batch loss must fall
# the 24-layer run's peak learning rate, warmup 1 step: at 3e-4 the
# fixed-batch loss fell 0.148 nats after one step and then rose to 12.53
# by the fourth (AdamW's first steps move every bf16 weight by ~lr with no
# warmup to damp them; the kernel step equals the plain one, gate c)
P21_LR = 1e-4


def train_shape(layers_note=None):
    """``SHAPES["train_4k"]`` cut to P21_BATCH x P21_SEQ in P21_MICRO
    microbatches, remat "full", with the launcher's chunks."""
    from repro_torch.configs import SHAPES
    return dataclasses.replace(
        SHAPES["train_4k"], global_batch=P21_BATCH, n_micro=P21_MICRO,
        remat="full", loss_chunk=128, attn_chunk=128)


def p21_matmul_grads(ec, report) -> dict:
    """(a) Each site shape of the training path at M = 8192: the dense
    Function's dX and dW (``ops.flex_matmul`` under autograd, the site's
    schedule) against autograd of the plain product, float32 within
    ``matmul_tol`` with a TF32 control it must reject, bf16 within
    ``matmul_tol`` plus one bf16 step of the value (≤ 2⁻⁷ of it: the two
    float32 sums may round to neighbouring bf16 values).  Returns the worst
    error and the mlp.in operands for the rows."""
    import torch
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    m = (P21_BATCH // P21_MICRO) * P21_SEQ
    shapes = {"attn.q": (2048, 2048), "attn.kv": (2048, 4096),
              "attn.out": (2048, 2048), "mlp.in": (2048, 5632),
              "mlp.gate": (2048, 5632), "mlp.out": (5632, 2048)}
    worst, keep = 0.0, {}
    for site, (k, n) in shapes.items():
        x0 = torch.randn((m, k), generator=gen, device=dev)
        w0 = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
        g0 = torch.randn((m, n), generator=gen, device=dev)
        line = [f"{site} ({m} x {k} @ {k} x {n})"]
        for dt in (torch.float32, torch.bfloat16):
            x = x0.to(dt).clone().requires_grad_()
            w = w0.to(dt).clone().requires_grad_()
            g = g0.to(dt)
            with ops.exec_config(ec):
                out = ops.flex_matmul(x, w, site=site)
            out.backward(g)
            xp = x.detach().clone().requires_grad_()
            wp = w.detach().clone().requires_grad_()
            ref = torch.matmul(xp.float(), wp.float()).to(dt)
            ref.backward(g)
            for label, got, want, (a, b) in (
                    ("dX", x.grad, xp.grad, (g, w.detach().t())),
                    ("dW", w.grad, wp.grad, (x.detach().t(), g))):
                tol = matmul_tol(a, b)
                err = (got.float() - want.float()).abs()
                if dt == torch.bfloat16:
                    # two float32 sums tol apart may round to neighbouring
                    # bf16 values: one bf16 step, ≤ 2⁻⁷ of the value
                    bound = tol + 2.0 ** -7 * torch.maximum(
                        want.float().abs(), got.float().abs())
                    need(bool((err <= bound).all()),
                         f"{site} bf16 {label}: {(err - bound).max().item()}"
                         f" over matmul_tol + one bf16 rounding")
                    line.append(f"bf16 {label} {err.max().item():.3e}")
                else:
                    e = err.max().item()
                    need(e <= tol, f"{site} float32 {label}: {e} > {tol}")
                    ctrl = (torch.matmul(tf32(a.float()), tf32(b.float()))
                            - want).abs().max().item()
                    need(ctrl > tol, f"{site} {label}: matmul_tol does not "
                         f"reject TF32 operands ({ctrl} <= {tol})")
                    line.append(f"float32 {label} {e:.3e} (tol {tol:.3e}, "
                                f"TF32 {ctrl:.3e})")
                    worst = max(worst, e)
            if site == "mlp.in" and dt == torch.bfloat16:
                keep = dict(x=x.detach(), w=w.detach(), g=g)
            del x, w, g, xp, wp, out, ref
        report("  " + "; ".join(line))
    torch.cuda.synchronize()
    keep["err"] = worst
    return keep


def p21_flash_tol(plain32, exact) -> float:
    """Float32 ``fa_backward`` against float64: the plain version run in
    float32 on the card sums the same products in other orders, so its own
    error against float64 is the scale; four times it (and one float32
    rounding of the largest output) is the bound.  TF32 products err ~2⁻¹¹
    per product and land outside it (checked)."""
    err = max((p.double() - e).abs().max().item()
              for p, e in zip(plain32, exact))
    top = max(e.abs().max().item() for e in exact)
    return 4 * err + 2.0 ** -24 * top


P21_FLASH_CASES = (  # (label, sq, skv, causal, window)
    ("causal", 4096, 4096, True, 0),
    ("window 1024", 4096, 4096, True, 1024),
    ("Sq<Skv", 2048, 4096, True, 0))


def flash_backward_case(report, gen, hd, label, bh, sq, skv, causal,
                        window) -> tuple:
    """One ``fa_backward`` case: float32 against the float64 plain version
    under ``p21_flash_tol`` with a TF32 control; bf16 under
    ``ref.flash_backward_check`` (the rounding scale of P̂ and dŜ) with P
    and dS truncated toward zero as the control it must reject; two runs
    bit-equal; the forward's O with lse equal to O without.  Returns
    (float32 error, bf16 error against plain, the bf16 operands)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import (flash_attention_backward_plain,
                                         flash_backward_check)

    dev = torch.device("cuda")
    kw = dict(causal=causal, window=window)
    q = torch.randn((bh, sq, hd), generator=gen, device=dev)
    k, v = (torch.randn((bh, skv, hd), generator=gen, device=dev)
            for _ in range(2))
    do = torch.randn((bh, sq, hd), generator=gen, device=dev)
    # float32
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    need(torch.equal(o, fa.flash_attention(q, k, v, **kw)),
         f"fa_forward hd {hd} {label} float32: O with lse differs")
    got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
    exact = flash_attention_backward_plain(
        q.double(), k.double(), v.double(), o.double(), lse.double(),
        do.double(), **kw)
    plain32 = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    tol = p21_flash_tol(plain32, exact)
    err = max((a.double() - e).abs().max().item()
              for a, e in zip(got, exact))
    need(err <= tol, f"fa_backward hd {hd} {label} float32: {err} > {tol}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf = flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctrl = max((a.double() - e).abs().max().item()
               for a, e in zip(tf, exact))
    need(ctrl > tol, f"fa_backward hd {hd} {label}: the float32 tolerance "
         f"does not reject TF32 ({ctrl} <= {tol})")
    del tf, plain32, exact, got, o, lse
    # bf16
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    del q, k, v, do
    ob, lseb = fa.flash_attention(qb, kb, vb, return_lse=True, **kw)
    need(torch.equal(ob, fa.flash_attention(qb, kb, vb, **kw)),
         f"fa_forward hd {hd} {label} bf16: O with lse differs")
    gb = fa.flash_attention_backward(qb, kb, vb, ob, lseb, dob, **kw)
    again = fa.flash_attention_backward(qb, kb, vb, ob, lseb, dob, **kw)
    need(all(torch.equal(a, b) for a, b in zip(gb, again)),
         f"fa_backward hd {hd} {label} bf16: two runs differ")
    plain = flash_attention_backward_plain(qb, kb, vb, ob, lseb, dob, **kw)
    weight = flash_attention_backward_plain(
        qb, kb, vb, ob, lseb, dob, magnitudes=True, **kw)
    checks = [flash_backward_check(a, p, w)
              for a, p, w in zip(gb, plain, weight)]
    need(all(c.ok() for c in checks),
         f"fa_backward hd {hd} {label} bf16: {checks}")
    trunc = flash_attention_backward_plain(
        qb, kb, vb, ob, lseb, dob, truncate=True, **kw)
    ctrls = [flash_backward_check(a, p, w)
             for a, p, w in zip(trunc, plain, weight)]
    need(not all(c.ok() for c in ctrls),
         f"fa_backward hd {hd} {label} bf16: the check does not reject "
         f"truncated P and dS: {ctrls}")
    errb = max((a - p).abs().max().item() for a, p in zip(gb, plain))
    report(f"  fa_backward hd {hd} {label} (BH {bh}, Sq {sq}, Skv {skv}): "
           f"float32 vs float64 {err:.3e} (tol {tol:.3e}, TF32 "
           f"{ctrl:.3e}); bf16 vs plain {errb:.3e}, (worst, rms) in units "
           f"of 2^-8 W for dQ/dK/dV "
           + ", ".join(f"({c.worst:.3f}, {c.rms:.4f})" for c in checks)
           + " (limits 4, 0.05); truncated control "
           + ", ".join(f"({c.worst:.3f}, {c.rms:.4f})" for c in ctrls)
           + "; two runs bit-equal; O with lse == O without")
    operands = dict(q=qb, k=kb, v=vb, o=ob, lse=lseb, do=dob, kw=kw)
    del gb, again, plain, weight, trunc
    return err, errb, operands


def p21_flash(report) -> dict:
    """(b) ``fa_backward`` against ``flash_attention_backward_plain`` at
    BH 64, S 4096, hd 64 and 128, causal / window / Sq < Skv
    (``flash_backward_case``).  Returns the worst errors and the bf16
    hd-64 causal operands for the row."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(22)
    worst32 = worstb = 0.0
    keep = {}
    for hd in (64, 128):
        for label, sq, skv, causal, window in P21_FLASH_CASES:
            err, errb, ops_ = flash_backward_case(report, gen, hd, label, 64,
                                                  sq, skv, causal, window)
            worst32, worstb = max(worst32, err), max(worstb, errb)
            if hd == 64 and label == "causal":
                keep = ops_
            del ops_
    torch.cuda.synchronize()
    keep["err"] = max(worst32, worstb)
    return keep


def _step_parts(cfg, shape, ec, params, batch):
    """(loss, grads, updated params, grad norm) of one AdamW step under
    ``ec`` (None: the plain path), the optimizer fresh."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as step_lib
    fn = step_lib.loss_for(cfg, shape)
    with ops.exec_config(ec or ops.ExecConfig()):
        loss, grads = step_lib.value_and_grad(fn, params, batch)
    new, _, metrics = opt_lib.adamw_update(
        opt_lib.AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=6), params,
        grads, opt_lib.init_opt_state(params))
    torch.cuda.synchronize()
    return loss, grads, new, metrics["grad_norm"]


def p21_step_vs_plain(ec, report) -> dict:
    """(c) StableLM-1.6B at full width and depth 2, one microbatch of
    2 x 4096: one step under the kernels (the train table, then every site
    forced weight- and input-stationary) against the plain step, float32
    and bf16, for the loss, every gradient and the updated parameters; and
    remat "none" == "full" bit for bit.  Tolerances: float32 — loss rtol
    1e-5, each gradient within 1e-4·max|plain| (the sums run over 8192 rows
    and two layers in other orders); bf16 — loss rtol
    2⁻⁷, each gradient's RMS difference within 2⁻⁴ of the plain one's
    RMS (activations round to bf16 at every site, and an element that
    lands next to a rounding boundary rounds apart); parameters, in both
    types, within lr times ``adamw_first_step_spread`` of the two runs'
    clipped gradients plus 2⁻²² of the parameter (float32 roundings), and
    in bf16 one bf16 step of the value (≤ 2⁻⁷ of it)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.train.optimizer import tree_leaves

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2)
    shape = dataclasses.replace(train_shape(), global_batch=2, n_micro=1)
    dev = torch.device("cuda")
    toks = torch.randint(0, cfg.vocab, (2, P21_SEQ + 1),
                         generator=torch.Generator(device=dev).manual_seed(5),
                         device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    lr = 3e-4
    worst = {}
    for dt in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=dev).manual_seed(3)
        params = model_lib.init_params(cfg, gen, dtype=dt, device=dev)
        pl, pg, pnew, pnorm = _step_parts(cfg, shape, None, params, batch)
        names = [n for n in _leaf_names(params)]
        for stat in ("output", "weight", "input"):
            ek = ec if stat == "output" else forced(ec, stat)
            kernel = _step_parts(cfg, shape, ek, params, batch)
            worst[(str(dt), stat)] = compare_steps(
                f"step at depth 2, {str(dt)[6:]}, {stat}-stationary",
                kernel, (pl, pg, pnew, pnorm), params, names, lr, report)
            del kernel
        del pg, pnew
        if dt == torch.bfloat16:
            # remat none == full, bit for bit, under the kernels
            none = dataclasses.replace(shape, remat="none")
            l0, g0, _, _ = _step_parts(cfg, none, ec, params, batch)
            l1, g1, _, _ = _step_parts(cfg, shape, ec, params, batch)
            need(torch.equal(l0, l1) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(g0),
                                                  tree_leaves(g1))),
                "remat none and full differ under the kernels")
            report(f"  remat none == full bit for bit (loss {l0.item():.6f})")
            del g0, g1
        del params
        free()
    return worst


def compare_steps(label, kernel, plain, params, names, lr, report,
                  finite_only=False) -> float:
    """One AdamW step under the kernels against the plain step (each
    ``_step_parts``' (loss, grads, updated params, grad norm)) on the same
    params and batch, with ``p21_step_vs_plain``'s tolerances: float32 —
    loss rtol 1e-5, each gradient within 1e-4·max|plain|; bf16 — loss
    rtol 2⁻⁷, each gradient's RMS difference within 2⁻⁴ of the plain
    one's RMS; parameters within lr times ``adamw_first_step_spread`` plus
    2⁻²² of the parameter, in bf16 plus one bf16 step.  ``finite_only``
    (a model whose float32 overflows where the reference's does): the
    gradients non-finite on the plain side are left out, the kernel step
    must be finite wherever the plain one is, and with a non-finite plain
    gradient the updated parameters (all moved by the global norm) are not
    compared.  Returns the worst gradient ratio."""
    import torch
    from repro_torch.train.optimizer import tree_leaves

    pl, pg, pnew, pnorm = plain
    kl, kg, knew, knorm = kernel
    f32 = params_dtype(params) == torch.float32
    if not finite_only or bool(torch.isfinite(pl)):
        need(bool(torch.isfinite(kl)), f"{label}: loss {kl.item()} not "
             f"finite (plain {pl.item()})")
        rl = abs(kl.item() - pl.item()) / abs(pl.item())
        need(rl <= (1e-5 if f32 else 2.0 ** -7),
             f"{label}: loss {kl.item()} vs plain {pl.item()}")
    gw, skipped = 0.0, 0
    for name, a, b in zip(names, tree_leaves(kg), tree_leaves(pg)):
        a, b = a.to(b.device).float(), b.float()
        if finite_only:
            fin = torch.isfinite(b)
            need(bool(torch.isfinite(a)[fin].all()), f"{label}: gradient "
                 f"{name} not finite where the plain one is")
            if not bool(fin.all()):
                skipped += 1
                continue
        if f32:
            r = ((a - b).abs().max() / b.abs().max()).item()
            lim = 1e-4
        else:
            r = ((a - b).pow(2).mean().sqrt()
                 / b.pow(2).mean().sqrt()).item()
            lim = 2.0 ** -4
        need(r <= lim, f"{label}: gradient {name} {r} > {lim}")
        gw = max(gw, r)
    pw = None
    if not finite_only or bool(torch.isfinite(pnorm)):
        pw = 0.0
        sk = torch.clamp(1.0 / torch.clamp(knorm, min=1e-9), max=1.0)
        sp = torch.clamp(1.0 / torch.clamp(pnorm, min=1e-9), max=1.0)
        for name, a, b, ga, gb, p0 in zip(
                names, tree_leaves(knew), tree_leaves(pnew),
                tree_leaves(kg), tree_leaves(pg), tree_leaves(params)):
            a, b, ga = a.to(b.device).float(), b.float(), ga.to(gb.device)
            # the clipped gradients as AdamW takes them (rounded to the
            # gradient's dtype)
            bound = lr * adamw_first_step_spread(
                (ga * sk.to(ga.dtype)).float(),
                (gb * sp.to(gb.dtype)).float()) \
                + 2.0 ** -22 * p0.float().abs()
            if not f32:
                bound = bound + 2.0 ** -7 * torch.maximum(a.abs(), b.abs())
            over = (a - b).abs() - bound
            need(bool((over <= 0).all()), f"{label}: updated {name} "
                 f"{over.max().item()} over its bound")
            pw = max(pw, ((a - b).abs().max() / lr).item())
    report(f"  {label} kernels vs plain: loss {kl.item():.6f} / "
           f"{pl.item():.6f}, worst gradient "
           f"{'max' if f32 else 'rms'}-relative {gw:.3e}, worst updated "
           f"parameter "
           + ("not compared (plain grad_norm not finite)" if pw is None
              else f"{pw:.3e} lr")
           + (f"; {skipped} of {len(names)} gradient leaves non-finite on "
              f"the plain side too (left out)" if finite_only else ""))
    return gw


def params_dtype(params):
    """The dtype of a params tree's matrices (its first 2-D leaf)."""
    from repro_torch.train.optimizer import tree_leaves
    return next(x.dtype for x in tree_leaves(params) if x.dim() >= 2)


def adamw_first_step_spread(ga, gb, eps: float = 1e-8):
    """How far AdamW's first update direction u(g) = g / (|g| + ε) (the
    bias-corrected m̂ / (√v̂ + ε) of a first step) can move between two
    runs whose clipped gradients are ``ga`` and ``gb``, per element: by the
    mean value theorem |u(a) − u(b)| ≤ |a − b|·ε / (min(|a|, |b|) + ε)²
    when the signs agree, at most 2 when they differ, plus 2⁻²⁰ for the
    float32 roundings of the update.  Where a gradient is near ε a
    last-bit difference moves the update by a visible share of lr; where
    it is large nothing does."""
    import torch
    m = torch.minimum(ga.abs(), gb.abs())
    spread = (ga - gb).abs() * eps / (m + eps) ** 2
    spread = torch.where(ga * gb < 0, torch.full_like(spread, 2.0),
                         torch.clamp(spread, max=2.0))
    return spread + 2.0 ** -20


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix


def p21_resume(ec, report) -> None:
    """(d) Depth 2, the cut train shape, bf16: 2 steps and a checkpoint
    under build/, a fresh Trainer resumed to step 4, and a straight 4-step
    run — every parameter, moment and the step-4 loss equal bit for bit.
    The checkpoint files are deleted afterwards."""
    import shutil

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("stablelm-1.6b"), n_layers=2)
    shape = train_shape()
    ckpt_dir = os.path.join(ROOT, "build", "p21_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=4)

    def trainer(steps, d):
        data = DataConfig(vocab=cfg.vocab, seq_len=P21_SEQ,
                          global_batch=P21_BATCH, seed=11)
        tc = TrainerConfig(steps=steps, ckpt_dir=d, ckpt_every=100, keep=1,
                           log_every=100, seed=4)
        return Trainer(cfg, shape, opt, tc, pipeline=TokenPipeline(data),
                       dtype=torch.bfloat16, exec_cfg=ec, device="cuda")

    try:
        t0 = time.perf_counter()
        trainer(2, ckpt_dir).run()
        t_save = time.perf_counter()
        t2 = trainer(4, ckpt_dir)
        log2 = t2.run()
        t_resumed = time.perf_counter()
        need([r["step"] for r in log2] == [3, 4],
             f"resume: steps {[r['step'] for r in log2]}")
        t3 = trainer(4, None)
        log3 = t3.run()
        need(log3[-1]["loss"] == log2[-1]["loss"],
             f"resume: step-4 loss {log2[-1]['loss']} vs straight "
             f"{log3[-1]['loss']}")
        for state in ("params", "mu", "nu"):
            a = t2.params if state == "params" else getattr(t2.opt_state,
                                                            state)
            b = t3.params if state == "params" else getattr(t3.opt_state,
                                                            state)
            need(all(torch.equal(x, y) for x, y in
                     zip(tree_leaves(a), tree_leaves(b))),
                 f"resume: {state} differ from the straight run")
        need(int(t2.opt_state.step) == int(t3.opt_state.step) == 4,
             "resume: optimizer step")
        report(f"  resume at depth 2: 2 steps + checkpoint "
               f"{t_save - t0:.1f} s, restore + 2 steps + checkpoint "
               f"{t_resumed - t_save:.1f} s; step-4 loss "
               f"{log2[-1]['loss']:.6f} == straight run's, every parameter "
               f"and moment bit-equal")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


def p21_full(report, card) -> dict:
    """(e) The published 24 layers through the launcher's path
    (``launch.train.make_trainer``, peak lr ``P21_LR``, warmup 1): 4 AdamW
    steps on one fixed batch (the loss must fall by P21_MIN_FALL nats,
    grad_norm finite), one profiled, then 2 steps from the TokenPipeline.
    Launch counts are reset just before and read just after."""
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.train.optimizer import tree_leaves

    args = launch.parse_args([
        "--arch", "stablelm-1.6b", "--steps",
        str(P21_FIXED_STEPS + P21_PIPE_STEPS), "--batch", str(P21_BATCH),
        "--seq", str(P21_SEQ), "--n-micro", str(P21_MICRO), "--remat",
        "full", "--lr", str(P21_LR), "--log-every", "1"])
    t0 = time.perf_counter()
    trainer = launch.make_trainer(args)
    trainer.init_state()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(trainer.params))
    report(f"  24-layer bring-up ({n_params / 1e9:.3f} B parameters, bf16, "
           f"AdamW float32 moments): {time.perf_counter() - t0:.1f} s")
    batch = trainer._next_batch()
    tokens = P21_BATCH * P21_SEQ
    reset_launches()
    losses, norms, times, prof, peak = fixed_batch_steps(
        trainer, batch, P21_FIXED_STEPS)
    fixed_launches = launch_counts()
    log = trainer.run()
    launches = launch_counts()
    need(all(torch.isfinite(torch.tensor(norms + [r["grad_norm"]
                                                  for r in log]))),
         f"24 layers: grad_norm not finite: {norms}")
    need(all(v == v for v in losses) and losses[0] - losses[-1]
         >= P21_MIN_FALL,
         f"24 layers: fixed-batch loss {losses} did not fall by "
         f"{P21_MIN_FALL}")
    need([r["step"] for r in log] == [5, 6], "24 layers: pipeline steps")
    steady = sorted(times[2:] + [r["dt"] for r in log])
    ms = 1e3 * steady[len(steady) // 2]
    report(f"  24 layers, {P21_BATCH} x {P21_SEQ} tokens a step in "
           f"{P21_MICRO} microbatches, remat full ({card}): fixed-batch "
           f"losses {[round(x, 4) for x in losses]} (fell "
           f"{losses[0] - losses[-1]:.4f} nats), grad_norm "
           f"{[round(x, 4) for x in norms]}; pipeline steps "
           f"{[(r['step'], round(r['loss'], 4)) for r in log]}; step times "
           f"{[round(1e3 * x, 1) for x in times + [r['dt'] for r in log]]} "
           f"ms; median of the steady steps {ms:.1f} ms, "
           f"{tokens / ms * 1e3:.0f} tokens/s; peak {peak:.2f} GiB")
    busy = report_step_profile(prof, times[1], ms, report)
    for key in ("output", "flash_attention", "flash_backward"):
        need(launches[key] > 0, f"24 layers: {key} never launched")
    report(f"  launches in the 24-layer run (4 fixed + 2 pipeline steps): "
           f"{ {k: v for k, v in launches.items() if v} }; the 4 fixed "
           f"steps: { {k: v for k, v in fixed_launches.items() if v} }")
    out = dict(launches=launches, ms=ms, tokens_per_s=tokens / ms * 1e3,
               peak_gib=peak, busy=busy / 1e3 / ms if busy else None,
               losses=losses)
    del trainer
    free()
    return out


def fixed_batch_steps(trainer, batch, steps) -> tuple:
    """``steps`` AdamW steps of ``trainer`` on one fixed ``batch``, the
    second under ``torch.profiler``: (losses, grad norms, step seconds,
    the profile, peak GiB)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    losses, norms, times = [], [], []
    prof = None
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 1:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                m = trainer.train_step(batch)
                torch.cuda.synchronize()
        else:
            m = trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        trainer.step += 1
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return (losses, norms, times, prof,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def report_step_profile(prof, wall_s, ms, report):
    """Report a profiled train step (``wall_s`` its wall under the
    profiler) against the unprofiled steps' median ``ms``: device busy
    time and share, kernels, families, top kernels.  Returns the busy
    microseconds (0: the profiler recorded no device time)."""
    busy, n_kernels, fam = device_breakdown(prof)
    top = [(k, us / 1e3, c) for k, (us, c) in device_tops(prof, 6) if us > 0]
    if busy:
        # the profiler slows the host, so the busy share is taken against
        # the unprofiled steps' median wall
        report(f"  profiled step: wall {1e3 * wall_s:.1f} ms under the "
               f"profiler, device busy {busy / 1e3:.1f} ms, "
               f"{100 * busy / 1e3 / ms:.1f}% of the median unprofiled step "
               f"({n_kernels} kernels); by family {fam}; top kernels (ms, "
               f"count) {[(k[:60], round(t, 2), c) for k, t, c in top]}")
    else:
        report("  profiled step: the profiler recorded no device time (not "
               "measured)")
    return busy


def p21_rows(mm, flash, launches) -> list:
    """The ``kernels`` rows of phase 21: ``fa_backward`` (bf16, BH 64, S
    4096, hd 64, causal) and the backward products dX and dW at mlp.in
    (M = 8192), beside the plain versions and PyTorch's own calls (the
    backward of ``scaled_dot_product_attention``; ``torch.matmul``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import (flash_attention_backward_plain,
                                         matmul_ref)

    saved = launch_counts()
    rows = []
    q, k, v, o, lse, do = (flash[n] for n in ("q", "k", "v", "o", "lse",
                                              "do"))
    kw = flash["kw"]
    bh, sq, hd = q.shape
    pairs = flash_pairs(bh, sq, k.shape[1], **kw)
    el = q.element_size()
    n_bytes = 5 * q.numel() * el + 3 * q.numel() * 4 + 2 * bh * sq * 4
    b_ms, b_by = bound_ms(n_bytes, 5 * 2.0 * hd * pairs)

    def call():
        return fa.flash_attention_backward(q, k, v, o, lse, do, **kw)

    qs, ks, vs = (t.detach()[None].requires_grad_() for t in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(qs, ks, vs,
                                             is_causal=kw["causal"])

        def library():
            return torch.autograd.grad(out, (qs, ks, vs), do[None],
                                       retain_graph=True)
        lib_ms = cuda_ms(library, iters=5)
    except RuntimeError as err:      # a yardstick only
        print(f"flash_backward: SDPA's backward refused ({str(err)[:160]})",
              file=sys.stderr)
        lib_ms = None
    rows.append({
        "name": "flash_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "note": "the gradient of _fa_kernel's function, which has no "
                "Pallas backward: the reference differentiates its XLA "
                "twin; launches: fa_backward calls (three kernels each) "
                "in phase 21's 24-layer run",
        "launches": launches["flash_backward"],
        "max_abs_err": flash["err"],
        "ms": cuda_ms(call, iters=10),
        "plain_ms": cuda_ms(lambda: flash_attention_backward_plain(
            q, k, v, o, lse, do, **kw), iters=2),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "device_ms": device_ms(call, calls=5),
        "head_dim": hd, "bh": bh, "seq": sq, **kw})
    x, w, g = mm["x"], mm["w"], mm["g"]
    m, kk = x.shape
    n = w.shape[1]
    xt = x.t().contiguous()
    for label, a, b in (("dx", g, w.t()), ("dw", xt, g)):
        mm_ms, by = bound_ms(
            (a.numel() + b.numel()) * el + a.shape[0] * b.shape[1] * 4,
            2.0 * a.shape[0] * a.shape[1] * b.shape[1])

        def kcall(a=a, b=b):
            return fm.flex_matmul(a, b, out_dtype=torch.float32)
        rows.append({
            "name": f"flex_output_backward_{label}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flex_matmul.cu",
            "replaces": "src/repro/kernels/flex_matmul.py:52",
            "launches": launches["output"],
            "max_abs_err": mm["err"],
            "ms": cuda_ms(kcall, iters=10),
            "plain_ms": cuda_ms(lambda a=a, b=b: matmul_ref(a, b), iters=3),
            "bound_ms": mm_ms, "bound_by": by,
            "library_ms": cuda_ms(lambda a=a, b=b: torch.matmul(a, b),
                                  iters=10),
            "device_ms": device_ms(kcall, calls=10),
            "shape": [a.shape[0], a.shape[1], b.shape[1]],
            "note": "fm_output at the backward product of mlp.in (M = "
                    f"{m}, K = {kk}, N = {n}); launches: every fm_output "
                    "launch of phase 21's 24-layer run, forward and "
                    "backward"})
    reset_launches(saved)
    return rows


def run_training(report, card):
    """Phase 21: training on the card (the module docstring)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import shape_exec_config

    free()
    t0 = time.perf_counter()
    cfg = get_config("stablelm-1.6b")
    shape = train_shape()
    report(f"phase 21 train shape: train_4k ({256} x {P21_SEQ}) cut to "
           f"{shape.global_batch} x {shape.seq_len} in {shape.n_micro} "
           f"microbatches (M = {shape.global_batch // shape.n_micro * P21_SEQ}"
           f" rows a site), remat {shape.remat}")
    ec = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
    report(ec.schedules.describe())
    mm = p21_matmul_grads(ec, report)
    report(f"[phase 21a: {time.perf_counter() - t0:.1f} s]")
    flash = p21_flash(report)
    report(f"[phase 21b: {time.perf_counter() - t0:.1f} s]")
    p21_step_vs_plain(ec, report)
    report(f"[phase 21c: {time.perf_counter() - t0:.1f} s]")
    p21_resume(ec, report)
    report(f"[phase 21d: {time.perf_counter() - t0:.1f} s]")
    full = p21_full(report, card)
    report(f"[phase 21e: {time.perf_counter() - t0:.1f} s]")
    rows = p21_rows(mm, flash, full["launches"])
    torch.cuda.synchronize()
    return full, rows


# ---------------------------------------------------------------------------
# phase 22: the other families train — fa_backward at hd 256, the expert
# route's backward, the kernel step against the plain step per family, and
# three families at full width through the launcher
# ---------------------------------------------------------------------------

P22_FLASH_CASES = (  # (label, BH, Sq, Skv, causal, window); hd 256
    ("causal", 16, 4096, 4096, True, 0),            # gemma-2b's cell
    ("window 2048", 32, 4096, 4096, True, 2048),    # recurrentgemma-9b's
    ("Sq<Skv", 16, 2048, 4096, True, 0))
P22_MOE = "deepseek-moe-16b"
# the expert capacity of one 2 x 4096 microbatch: _capacity(8192, 6, 64,
# 1.25) = 961 rows an expert
P22_CAPACITY = 961
P22_STEP_CASES = (  # (arch, layers: None = published, batch, seq)
    (P22_MOE, 2, 1, 4096),             # the dense first layer + one MoE
    ("gemma-2b", 2, 1, 4096),
    ("recurrentgemma-9b", 3, 1, 4096),  # one Griffin group
    ("whisper-tiny", None, 2, 448),    # 2 x 1500 frames (30 s) feed it
    ("mamba2-1.3b", 1, 1, 4096))       # phase 19's finite prefix
P22_WHISPER_FRAMES = 1500
P22_FULL = (  # (arch, layers: None = published); 4 x 4096 in 2 micro
    ("gemma-2b", None),
    (P22_MOE, 4),                      # the dense first + 3 MoE layers
    ("recurrentgemma-9b", 6))          # two Griffin groups
P22_STEPS = 4


def cut_config(arch, layers):
    """``arch``'s published config at ``layers`` layers (None: uncut)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def p22_flash(report) -> dict:
    """(a) ``fa_backward`` at hd 256 (``flash_backward_case``) at
    gemma-2b's and recurrentgemma-9b's cells and one Sq < Skv case.
    Returns the worst error and the bf16 operands of the first two."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(25)
    worst, keep = 0.0, {}
    for label, bh, sq, skv, causal, window in P22_FLASH_CASES:
        err, errb, operands = flash_backward_case(report, gen, 256, label,
                                                  bh, sq, skv, causal, window)
        worst = max(worst, err, errb)
        if label != "Sq<Skv":
            keep[label] = operands
        del operands
        free()
    keep["err"] = worst
    return keep


def p22_expert(report) -> dict:
    """(b) The expert route under autograd (``ops.flex_expert_matmul``'s
    dense Function under DeepSeek-MoE-16B's train table) at its layer-1
    experts_in / experts_gate / experts_out shapes, C = 961: dX and dW
    against autograd of the plain batched float32 product, per expert
    within ``expert_tols`` of each backward product, float32 with a TF32
    control it must reject, bf16 plus one bf16 step of the value; at
    C = 2 the batched dX (one launch over the experts, Wᵀ read in place)
    equals per-expert launches bit for bit.  Returns the worst float32
    error and the bf16 experts_in operands for the rows."""
    import torch
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import shape_exec_config

    cfg = cut_config(P22_MOE, 2)
    ec = shape_exec_config(cfg, train_shape(), use_kernels=True,
                           device="cuda")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.expert_d_ff
    worst, keep = 0.0, {}
    for site, (k, n) in (("moe.experts_in", (d, f)),
                         ("moe.experts_gate", (d, f)),
                         ("moe.experts_out", (f, d))):
        x0 = torch.randn((e, P22_CAPACITY, k), generator=gen, device=dev)
        w0 = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
        g0 = torch.randn((e, P22_CAPACITY, n), generator=gen, device=dev)
        line = [f"{site} ({e} x {P22_CAPACITY} x {k} @ {k} x {n})"]
        for dt in (torch.float32, torch.bfloat16):
            x, w = (t.to(dt).clone().requires_grad_() for t in (x0, w0))
            g = g0.to(dt)
            with ops.exec_config(ec):
                out = ops.flex_expert_matmul(x, w, site=site)
            out.backward(g)
            xp, wp = (t.detach().clone().requires_grad_() for t in (x, w))
            torch.matmul(xp.float(), wp.float()).to(dt).backward(g)
            for label, got, want, (a, b) in (
                    ("dX", x.grad, xp.grad, (g, w.detach().transpose(-1, -2))),
                    ("dW", w.grad, wp.grad,
                     (x.detach().transpose(-1, -2), g))):
                tol = expert_tols(a, b)
                err = (got.float() - want.float()).abs()
                if dt == torch.bfloat16:
                    bound = tol + 2.0 ** -7 * torch.maximum(
                        want.float().abs(), got.float().abs())
                    need(bool((err <= bound).all()),
                         f"{site} bf16 {label}: {(err - bound).max().item()}"
                         f" over expert_tols + one bf16 rounding")
                    line.append(f"bf16 {label} {err.max().item():.3e}")
                else:
                    need(bool((err <= tol).all()), f"{site} float32 {label}:"
                         f" {(err - tol).max().item()} over expert_tols")
                    ctrl = (torch.matmul(tf32(a.float()), tf32(b.float()))
                            - want).abs()
                    need(bool((ctrl > tol).any()), f"{site} {label}: "
                         f"expert_tols does not reject TF32 operands")
                    e32 = err.max().item()
                    line.append(f"float32 {label} {e32:.3e} (tol "
                                f"{tol.max().item():.3e}, TF32 "
                                f"{ctrl.max().item():.3e})")
                    worst = max(worst, e32)
            if site == "moe.experts_in" and dt == torch.bfloat16:
                keep = dict(x=x.detach(), w=w.detach(), g=g)
            del x, w, g, xp, wp, out
        report("  " + "; ".join(line))
        del x0, w0, g0
    # decode capacity: the batched dX launch equals per-expert launches
    a = torch.randn((e, 2, f), generator=gen, device=dev).bfloat16()
    wt = (torch.randn((e, d, f), generator=gen, device=dev)
          * d ** -0.5).bfloat16().transpose(-1, -2)
    n0 = fm.LAUNCHES["output_experts"]
    batched = fm.flex_matmul(a, wt, out_dtype=torch.float32)
    need(fm.LAUNCHES["output_experts"] == n0 + 1,
         "C = 2: the transposed expert B did not take one batched launch")
    need(all(torch.equal(batched[i], fm.flex_matmul(
        a[i], wt[i], out_dtype=torch.float32)) for i in range(e)),
        "C = 2: the batched dX differs from per-expert launches")
    report(f"  C = 2: dX = dY·Wᵀ over {e} experts in one launch (Wᵀ the "
           f"transposed view of the stored (E, K, N)) == {e} per-expert "
           f"launches bit for bit")
    torch.cuda.synchronize()
    keep["err"] = worst
    return keep


def p22_batch(cfg, batch, seq, seed=5):
    """A fixed training batch on the card: random tokens and next-token
    labels, and for an encoder-decoder 30 s of stub frame embeddings."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (batch, seq + 1), generator=gen,
                         device=dev)
    out = {"tokens": toks[:, :-1].contiguous(),
           "labels": toks[:, 1:].contiguous()}
    if cfg.encoder_decoder:
        out["frames"] = 0.02 * torch.randn(
            (batch, P22_WHISPER_FRAMES, cfg.d_model), generator=gen,
            device=dev)
    return out


@contextlib.contextmanager
def same_routing(tape, replay):
    """Route every MoE layer as ``tape`` says: record each ``moe.top_k``
    choice (``replay`` False) or take the recorded expert indices back in
    order (True), the gate values gathered from this run's own router
    probabilities — so a run whose router logits differ from the
    recording run's in their last bits sends every token to the same
    experts, as phase 15's oracle routes as the path under test
    (``router_logits``).  ``tape["flips"]`` counts the tokens whose expert
    set the replaying run would have chosen otherwise."""
    import torch
    from repro_torch.models import moe

    own = moe.top_k
    pos = [0]

    def top_k(probs, k):
        vals, idx = own(probs, k)
        if not replay:
            tape["idx"].append(idx)
            return vals, idx
        want = tape["idx"][pos[0]]
        pos[0] += 1
        tape["flips"] += int((torch.sort(want, -1)[0]
                              != torch.sort(idx, -1)[0]).any(-1).sum())
        return probs.gather(-1, want), want
    moe.top_k = top_k
    try:
        yield tape
    finally:
        moe.top_k = own


def p22_steps(report) -> dict:
    """(c) At full width and cut depth (``P22_STEP_CASES``), one AdamW step
    under the kernels (the train table) against the plain step, float32
    and bf16 (``compare_steps``), the plain step routed as the kernel step
    (``same_routing``: in bf16 the two hidden states differ by roundings,
    which move a share of the MoE's top-k choices, each moving a token's
    whole contribution between experts; the flips are reported); for the
    MoE, remat none == full bit for bit under the kernels.  mamba2-1.3b inherits the reference's SSD mask,
    whose float32 decays overflow at full width: its gradients non-finite
    on the plain side are counted and left out, and the kernel step must
    be finite wherever the plain one is.  Returns the worst gradient ratio
    per (arch, dtype)."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config

    dev = torch.device("cuda")
    lr = 3e-4
    worst = {}
    for arch, layers, b, seq in P22_STEP_CASES:
        t0 = time.perf_counter()
        cfg = cut_config(arch, layers)
        shape = dataclasses.replace(train_shape(), global_batch=b,
                                    n_micro=1, seq_len=seq)
        ec = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
        batch = p22_batch(cfg, b, seq)
        finite_only = cfg.ssm.enabled
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(3)
            params = model_lib.init_params(cfg, gen, dtype=dt, device=dev)
            names = list(_leaf_names(params))
            tape = {"idx": [], "flips": 0}
            with same_routing(tape, replay=False):
                kernel = _step_parts(cfg, shape, ec, params, batch)
            if dt == torch.float32:
                # the first step's float32 trees wait on the host, so the
                # second step fits beside the params (recurrentgemma-9b at
                # 3 layers: 1.75 B parameters)
                kernel = _host_parts(kernel)
            with same_routing(tape, replay=True):
                plain = _step_parts(cfg, shape, None, params, batch)
            label = (f"{arch} at {cfg.n_layers} layers, {b} x {seq}, "
                     f"{str(dt)[6:]}")
            if cfg.moe.enabled:
                label += (f" (plain routed as the kernels; it would route "
                          f"{tape['flips']} of {len(tape['idx']) * b * seq}"
                          f" token choices otherwise)")
            worst[(arch, str(dt))] = compare_steps(
                label, kernel, plain, params, names, lr, report,
                finite_only=finite_only)
            del plain, kernel, tape
            if cfg.moe.enabled and dt == torch.bfloat16:
                none = dataclasses.replace(shape, remat="none")
                l0, g0, _, _ = _step_parts(cfg, none, ec, params, batch)
                l1, g1, _, _ = _step_parts(cfg, shape, ec, params, batch)
                need(torch.equal(l0, l1) and all(
                    torch.equal(x, y) for x, y in
                    zip(_leaves_of(g0), _leaves_of(g1))),
                    f"{arch}: remat none and full differ under the kernels")
                report(f"  {arch}: remat none == full bit for bit (loss "
                       f"{l0.item():.6f})")
                del g0, g1
            del params
            free()
        report(f"  [{arch}: {time.perf_counter() - t0:.1f} s]")
    return worst


def _host_parts(parts):
    """``_step_parts``' (loss, grads, updated params, grad norm) with the
    two trees moved to host memory (``compare_steps`` brings each leaf
    back beside its counterpart)."""
    loss, grads, new, norm = parts

    def host(t):
        return ({k: host(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to("cpu"))
    return loss, host(grads), host(new), norm


def _leaves_of(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)


def p22_full(report, card) -> dict:
    """(d) ``P22_FULL`` at full width through the launcher's path
    (``launch.train.make_trainer`` with the cut config, peak lr
    ``P21_LR``, warmup 1, 4 x 4096 tokens a step in 2 microbatches, remat
    full): 4 AdamW steps on one fixed batch, the second profiled; the loss
    must fall by P21_MIN_FALL nats and every grad_norm be finite.  Launch
    counts are reset just before each run and read just after; fm_output,
    the flash forward and (with attention) ``fa_backward`` must have
    launched.  Returns per arch the launches, ms a step, tokens/s, peak
    GiB and busy share."""
    import torch
    from repro_torch.launch import train as launch
    from repro_torch.train.optimizer import tree_leaves

    out = {}
    for arch, layers in P22_FULL:
        cfg = cut_config(arch, layers)
        args = launch.parse_args([
            "--arch", arch, "--steps", str(P22_STEPS), "--batch",
            str(P21_BATCH), "--seq", str(P21_SEQ), "--n-micro",
            str(P21_MICRO), "--remat", "full", "--lr", str(P21_LR),
            "--log-every", "1"])
        t0 = time.perf_counter()
        trainer = launch.make_trainer(args, cfg=cfg)
        trainer.init_state()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tree_leaves(trainer.params))
        batch = trainer._next_batch()
        report(f"  {arch} at {cfg.n_layers} layers: bring-up "
               f"({n_params / 1e9:.3f} B parameters, bf16, AdamW float32 "
               f"moments) {time.perf_counter() - t0:.1f} s")
        reset_launches()
        losses, norms, times, prof, peak = fixed_batch_steps(
            trainer, batch, P22_STEPS)
        launches = launch_counts()
        need(all(torch.isfinite(torch.tensor(norms))),
             f"{arch}: grad_norm not finite: {norms}")
        need(all(v == v for v in losses) and losses[0] - losses[-1]
             >= P21_MIN_FALL, f"{arch}: fixed-batch loss {losses} did not "
             f"fall by {P21_MIN_FALL}")
        for key in ("output", "flash_attention", "flash_backward"):
            need(launches[key] > 0, f"{arch}: {key} never launched")
        tokens = P21_BATCH * P21_SEQ
        steady = sorted(times[2:])
        ms = 1e3 * steady[len(steady) // 2]
        report(f"  {arch} at {cfg.n_layers} layers, {P21_BATCH} x {P21_SEQ}"
               f" tokens a step in {P21_MICRO} microbatches, remat full "
               f"({card}): fixed-batch losses {[round(x, 4) for x in losses]}"
               f" (fell {losses[0] - losses[-1]:.4f} nats), grad_norm "
               f"{[round(x, 4) for x in norms]}; step times "
               f"{[round(1e3 * x, 1) for x in times]} ms; median of the "
               f"steady steps {ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s;"
               f" peak {peak:.2f} GiB")
        busy = report_step_profile(prof, times[1], ms, report)
        report(f"  launches in the {P22_STEPS} steps: "
               f"{ {k: v for k, v in launches.items() if v} }")
        out[arch] = dict(launches=launches, ms=ms,
                         tokens_per_s=tokens / ms * 1e3, peak_gib=peak,
                         busy=busy / 1e3 / ms if busy else None,
                         losses=losses, layers=cfg.n_layers)
        del trainer, batch, prof
        free()
    return out


def p22_rows(flash, expert, full) -> list:
    """The ``kernels`` rows of phase 22: ``fa_backward`` at hd 256 (bf16)
    at gemma-2b's and recurrentgemma-9b's cells, beside SDPA's backward
    (the window as a boolean mask), and the expert backward products dX and
    dW at experts_in (C = 961, bf16) beside ``torch.bmm``.  Launches are
    those of the (d) runs: ``fa_backward`` calls in gemma-2b's /
    recurrentgemma-9b's, every ``fm_output`` launch in DeepSeek-MoE-16B's
    (the expert products at C = 961 loop the 2-D kernel per expert)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels.ref import (expert_matmul_ref,
                                         flash_attention_backward_plain)

    saved = launch_counts()
    rows = []
    for label, arch, name in (("causal", "gemma-2b", "flash_backward_hd256"),
                              ("window 2048", "recurrentgemma-9b",
                               "flash_backward_hd256_window")):
        op = flash[label]
        q, k, v, o, lse, do = (op[n] for n in ("q", "k", "v", "o", "lse",
                                               "do"))
        kw = op["kw"]
        bh, sq, hd = q.shape
        pairs = flash_pairs(bh, sq, k.shape[1], **kw)
        el = q.element_size()
        n_bytes = 5 * q.numel() * el + 3 * q.numel() * 4 + 2 * bh * sq * 4
        b_ms, b_by = bound_ms(n_bytes, 5 * 2.0 * hd * pairs)

        def call(q=q, k=k, v=v, o=o, lse=lse, do=do, kw=kw):
            return fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
        qs, ks, vs = (t.detach()[None].requires_grad_() for t in (q, k, v))
        try:
            if kw["window"]:
                pos = torch.arange(sq, device=q.device)
                mask = ((pos[:, None] >= pos[None]) & (
                    pos[:, None] - pos[None] < kw["window"]))
                sdpa = F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=mask)
            else:
                sdpa = F.scaled_dot_product_attention(qs, ks, vs,
                                                      is_causal=True)

            def library(sdpa=sdpa, qs=qs, ks=ks, vs=vs, do=do):
                return torch.autograd.grad(sdpa, (qs, ks, vs), do[None],
                                           retain_graph=True)
            lib_ms = cuda_ms(library, iters=5)
            del sdpa
        except RuntimeError as err:      # a yardstick only
            print(f"{name}: SDPA's backward refused ({str(err)[:160]})",
                  file=sys.stderr)
            lib_ms = None
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:25",
            "note": "the gradient of _fa_kernel's function at hd 256 (no "
                    "Pallas backward: the reference differentiates its XLA "
                    f"twin); {arch}'s cell; launches: fa_backward calls in "
                    f"phase 22's {arch} run",
            "launches": full[arch]["launches"]["flash_backward"],
            "max_abs_err": flash["err"],
            "ms": cuda_ms(call, iters=5),
            "plain_ms": cuda_ms(lambda q=q, k=k, v=v, o=o, lse=lse, do=do,
                                kw=kw: flash_attention_backward_plain(
                                    q, k, v, o, lse, do, **kw), iters=2),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "device_ms": device_ms(call, calls=3),
            "head_dim": hd, "bh": bh, "seq": sq, **kw})
        del qs, ks, vs
    x, w, g = expert["x"], expert["w"], expert["g"]
    e, c, kk = x.shape
    n = w.shape[-1]
    el = x.element_size()
    xt = x.transpose(-1, -2).contiguous()
    for label, a, b in (("dx", g, w.transpose(-1, -2)), ("dw", xt, g)):
        m_, k_, n_ = a.shape[1], a.shape[2], b.shape[2]
        mm_ms, by = bound_ms((a.numel() + b.numel()) * el + e * m_ * n_ * 4,
                             2.0 * e * m_ * k_ * n_)

        def kcall(a=a, b=b):
            return fm.flex_matmul(a, b, out_dtype=torch.float32)
        rows.append({
            "name": f"flex_output_experts_backward_{label}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flex_matmul.cu",
            "replaces": "src/repro/kernels/flex_matmul.py:52",
            "launches": full[P22_MOE]["launches"]["output"],
            "max_abs_err": expert["err"],
            "ms": cuda_ms(kcall, iters=5),
            "plain_ms": cuda_ms(lambda a=a, b=b: expert_matmul_ref(a, b),
                                iters=2),
            "bound_ms": mm_ms, "bound_by": by,
            "library_ms": cuda_ms(lambda a=a, b=b: torch.bmm(a, b),
                                  iters=5),
            "device_ms": device_ms(kcall, calls=3),
            "shape": [e, m_, k_, n_],
            "note": f"fm_output over the experts at the backward product of "
                    f"experts_in (E = {e}, C = {c}, K = {kk}, N = {n}; 2-D "
                    f"launches expert by expert above 16 rows); launches: "
                    f"every fm_output launch of phase 22's {P22_MOE} run"})
    reset_launches(saved)
    return rows


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments for what runs inside:
    gemma-2b's 18-layer step peaks ~9 GiB below the card's 79 GiB, and
    fixed segments can fragment that margin away (a 2.25 GiB AdamW
    temporary refused with 7.55 GiB reserved but unallocated).  Set back
    after, with the cache emptied on both sides (CUDA-graph captures run
    outside it)."""
    import torch
    setting = torch.cuda.memory._set_allocator_settings
    free()
    setting("expandable_segments:True")
    try:
        yield
    finally:
        free()
        setting("expandable_segments:False")
        free()


def run_families_training(report, card):
    """Phase 22: the other families train on the card (the module
    docstring)."""
    import torch

    free()
    t0 = time.perf_counter()
    flash = p22_flash(report)
    report(f"[phase 22a: {time.perf_counter() - t0:.1f} s]")
    expert = p22_expert(report)
    report(f"[phase 22b: {time.perf_counter() - t0:.1f} s]")
    p22_steps(report)
    report(f"[phase 22c: {time.perf_counter() - t0:.1f} s]")
    with expandable_segments():
        full = p22_full(report, card)
    report(f"[phase 22d: {time.perf_counter() - t0:.1f} s]")
    rows = p22_rows(flash, expert, full)
    torch.cuda.synchronize()
    return full, rows


# ---------------------------------------------------------------------------
# phase 24: the serving CLI, and the last two configs — Qwen2-VL-72B
# (M-RoPE, the vision prefix) and Llama-4-Scout (top-1 MoE with a shared
# expert) — at published width, cut in depth
# ---------------------------------------------------------------------------

# the layers each config keeps: its bf16 weights, the plan's zero-padded
# copies of the ragged sites (``wpad``: Qwen2-VL's three MLP leaves, whose
# d_ff 29568 is 115.5 blocks of 256, and Llama-4's head, vocab 202048) and
# the 2 x 4096 prefill's temporaries within the card's 80 GB
P24_LAYERS = {"qwen2-vl-72b": 20, "llama4-scout-17b-a16e": 12}
P24_CLI = ["--arch", "stablelm-1.6b", "--requests", "4", "--max-new", "8",
           "--device", "cuda"]
# the vision prefix of a 2 x 4096 prefill: a 32 x 32 patch grid, N_VIS_STUB
# rows (``model.n_vis``)
P24_GRID = 32
# the flash kernel at hd 128 at the prefill cell (S 4096, causal), at the
# (batch, head) rows each config's 2 x 4096 prefill gives it: Qwen2-VL's
# 2 x 64 and Llama-4's 2 x 40 (GQA repeats k / v to every q head)
FLASH128_CASES = (
    ("hd-128 prefill cell (Qwen2-VL's 2 x 64 B.H), causal", 128, 4096,
     4096, True, 0),
    ("hd-128 prefill cell (Llama-4's 2 x 40 B.H), causal", 80, 4096, 4096,
     True, 0))
P24_KERNELS = ("block_sparse", "block_sparse_sum", "output", "output_sum",
               "flash_attention")


def p24_front_door(report, card) -> dict:
    """(a) ``repro_torch.launch.serve.main`` at StableLM-1.6B's published
    config, as a user starts it: bf16 weights, the dense table's kernels.
    Returns its launches."""
    import torch
    from repro_torch.launch import serve
    reset_launches()
    t0 = time.perf_counter()
    res = serve.main(P24_CLI)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_req, n_new = int(P24_CLI[3]), int(P24_CLI[5])
    need(sorted(res) == list(range(1, n_req + 1))
         and all(len(t) == n_new for t in res.values()),
         f"the serving CLI served {[len(t) for t in res.values()]}")
    launched = {k: v for k, v in counts.items() if v}
    report(f"phase 24 (a): python -m repro_torch.launch.serve "
           f"{' '.join(P24_CLI)}: {len(res)} requests x {n_new} tokens in "
           f"{wall:.1f} s (engine build and graph capture included); "
           f"launches {launched} ({card})")
    need(counts["output"] > 0, "the serving CLI launched no fm_output")
    del res
    free()
    return counts


def p24_batch(cfg, b, s, streams):
    """A 2 x 4096 prompt batch of a vision config: tokens, ``vis_embeds``
    (the patch embeddings of a ``P24_GRID``-square grid, N_VIS_STUB rows)
    and ``mrope_positions``: ``streams="grid"`` numbers the patches t 0,
    h their row, w their column and the text after them at 32 + i on all
    three streams, as Qwen2-VL does; ``"text"`` gives every stream the
    text position (t = h = w)."""
    import numpy as np
    import torch
    from repro_torch.models import model as model_lib
    n_vis = model_lib.n_vis(cfg, s)
    need(n_vis == P24_GRID ** 2, f"n_vis {n_vis} is not a "
         f"{P24_GRID} x {P24_GRID} grid")
    rng = np.random.default_rng(SEED + 24)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    if streams == "grid":
        side = P24_GRID
        text = side + np.arange(s - n_vis)
        pos = np.stack([
            np.concatenate([np.zeros(n_vis, np.int64), text]),
            np.concatenate([np.repeat(np.arange(side), side), text]),
            np.concatenate([np.tile(np.arange(side), side), text])])
    else:
        pos = np.broadcast_to(np.arange(s), (3, s))
    return {
        "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, size=(b, s)),
                                  device="cuda"),
        "vis_embeds": 0.02 * torch.randn((b, n_vis, cfg.d_model),
                                         generator=gen, device="cuda"),
        "mrope_positions": torch.as_tensor(
            np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, b, s))),
            device="cuda")}


def p24_prefill(cfg, sp_cfg, params, report, card) -> dict:
    """A 2 x 4096 prefill with the vision prefix (1024 rows of patch
    embeddings) and a patch grid's t / h / w streams, through the flash
    kernel at hd 128: the dense prefill table (flash launches = layers),
    the planned plan (logits equal bit for bit), the plain path (within
    5% of max |logit|; a MoE stack's plain run takes the kernel run's
    expert choices, ``same_routing``, as phase 22's plain step does, and
    the tokens its own router would send elsewhere are counted), and the
    control: with t = h = w the logits of an
    M-RoPE stack must differ, those of a full-rotary one (Llama-4 ignores
    the streams) must not.  Returns the flash launches and the seconds."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config
    shape = prefill_shape()
    b, s = shape.global_batch, shape.seq_len
    t0 = time.perf_counter()
    dense_pf = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
    planned_pf = shape_exec_config(sp_cfg, shape, use_kernels=True,
                                   params=params, device="cuda")
    attached = planned_pf.plan.attach(params)
    report(f"{cfg.name} prefill table and plan bring-up: "
           f"{time.perf_counter() - t0:.1f} s")
    batch = p24_batch(cfg, b, s, "grid")

    def prefill(ec, p, bt=batch):
        return _under(ec, lambda: model_lib.prefill(p, cfg, bt))

    moe = cfg.moe.enabled
    tape = {"idx": [], "flips": 0}
    before = launch_counts()["flash_attention"]
    logits, cold = _timed(lambda: prefill(dense_pf, params))
    per_prefill = launch_counts()["flash_attention"] - before
    # a MoE stack records this run's expert choices for the plain run
    with (same_routing(tape, replay=False) if moe
          else contextlib.nullcontext()):
        again, wall = _timed(lambda: prefill(dense_pf, params))
    out = {"per_prefill": per_prefill, "prefill_s": wall}
    report(f"{cfg.name} bf16 prefill with the vision prefix ({P24_GRID} x "
           f"{P24_GRID} patches, distinct t/h/w streams), dense table: "
           f"{wall:.3f} s warm ({cold:.3f} s the first) for {b} x {s} "
           f"tokens = {1e3 * wall / (b * s):.4f} ms per prompt token; "
           f"{per_prefill} flash launches at hd {cfg.head_dim}; a second "
           f"run's logits equal bit for bit: {torch.equal(again, logits)} "
           f"({card})")
    need(torch.equal(again, logits), f"{cfg.name}: two prefills differ")
    need(per_prefill == cfg.n_layers, f"{cfg.name}: flash kernel launched "
         f"{per_prefill} times in one prefill, not {cfg.n_layers}")
    need(bool(torch.isfinite(logits).all())
         and logits.shape == (b, 1, cfg.vocab),
         f"{cfg.name}: bad prefill logits")
    logits_p, wall = _timed(lambda: prefill(planned_pf, attached))
    out["planned_prefill_s"] = wall
    same = torch.equal(logits_p, logits)
    report(f"{cfg.name} bf16 prefill, planned (skip fraction "
           f"{planned_pf.plan.block_skip_fraction():.4f}): {wall:.3f} s; "
           f"logits == dense table bit for bit: {same}")
    need(same, f"{cfg.name}: planned prefill logits differ from the dense "
         f"table's")
    del planned_pf, attached, logits_p
    free()
    with (same_routing(tape, replay=True) if moe
          else contextlib.nullcontext()):
        logits_0, wall = _timed(lambda: prefill(None, params))
    diff = (logits_0 - logits).abs().max().item()
    tol = 0.05 * logits.abs().max().item()
    routed = ""
    if moe:
        free_0, _ = _timed(lambda: prefill(None, params))
        routed = (f" (routed as the kernel run: its own router would send "
                  f"{tape['flips']} of {b * s * cfg.n_layers} (token, layer)"
                  f" pairs to another expert; routed freely, max |diff| "
                  f"{(free_0 - logits).abs().max().item():.3e}, not gated)")
        del free_0
    report(f"{cfg.name} bf16 prefill, plain: {wall:.3f} s; logits vs dense "
           f"table max |diff| = {diff:.3e}, tol {tol:.3e}{routed}")
    need(diff <= tol, f"{cfg.name}: plain prefill logits off by {diff}")
    text = p24_batch(cfg, b, s, "text")
    logits_t, _ = _timed(lambda: prefill(dense_pf, params, text))
    moved = (logits_t - logits).abs().max().item()
    mrope = cfg.rope == "mrope"
    report(f"{cfg.name} control: the same prefill with t = h = w (rope "
           f"{cfg.rope}): max |logit change| {moved:.3e} (must be "
           f"{'> 0' if mrope else '0'})")
    need((moved > 0) == mrope, f"{cfg.name}: the t/h/w streams "
         f"{'do not move' if mrope else 'move'} the logits")
    out["total"] = launch_counts()["flash_attention"] - before
    del dense_pf
    free()
    return out


def p24_config(arch, report, card) -> dict:
    """One of the two configs at published width, ``P24_LAYERS`` deep:
    layer 0's sites against their plain versions (the MoE's expert sites
    and router as in phase 15), the planned engine (4 slots, 4 requests x
    8 new) == its ``step()`` oracle, the dense table == the plan bit for
    bit, the plain engine within 5% (phase 16's harness; the MoE's oracle
    step profiled, its expert-batched launches counted, its plain engine
    routed as the planned one), then ``p24_prefill``.  Returns its
    launches, worst errors and figures."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, sp_cfg, params, planned, dense = family_bring_up(
        arch, report, layers=P24_LAYERS[arch])
    report(f"{arch}: the matmul kernels vs their plain versions at layer "
           f"0's sites")
    errs = check_sites(params, planned, dense, report)["errs"]
    moe = cfg.moe.enabled
    kernels = P24_KERNELS
    if moe:
        checked = p15_kernels(cfg, params, planned, dense, report)
        errs.update(checked["errs"])
        p15_router(cfg, params, planned, dense, report)
        kernels += ("block_sparse_experts", "block_sparse_experts_sum",
                    "output_experts", "output_experts_sum")
        del checked
    free()
    report(f"{arch}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           f"allocated after the site checks")
    reset_launches()
    rates = {}
    prompts, _, logits_p = family_serve(
        cfg, params, planned, dense, report, card, rates=rates,
        on_oracle=(lambda eng: p15_profile(eng, report)) if moe else None)
    family_plain(cfg, params, prompts, logits_p, report,
                 routed_as=planned if moe else None)
    del planned, dense
    free()
    report(f"{arch}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           f"allocated after the engines, the decode plan dropped")
    pf = p24_prefill(cfg, sp_cfg, params, report, card)
    torch.cuda.synchronize()
    counts = launch_counts()
    launches = {k: counts[k] for k in kernels}
    report(f"main-path launches ({arch}, phase 24): {launches}")
    for name, count in launches.items():
        need(count > 0, f"kernel {name} never launched in {arch}'s run")
    figures = {
        "layers": cfg.n_layers, "peak_gib": round(
            torch.cuda.max_memory_allocated() / 2**30, 2),
        **{k: round(v, 4) for k, v in rates.items()},
        "prefill_s": round(pf["prefill_s"], 4),
        "planned_prefill_s": round(pf["planned_prefill_s"], 4),
        "wall_s": round(time.perf_counter() - t0, 1)}
    report(f"{arch} (phase 24): {json.dumps(figures)} ({card})")
    del params
    free()
    report(f"{arch}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
           f"allocated after its weights were dropped")
    return {"launches": launches, "errs": errs, "figures": figures,
            "flash": pf}


def run_last_configs(report, card):
    """Phase 24.  Returns (launches over the phase, worst errors per
    kernel, the hd-128 flash row, the per-config figures)."""
    t0 = time.perf_counter()
    checked = check_flash(report, FLASH128_CASES, hd=128, seed=24)
    free()
    launches = p24_front_door(report, card)
    report(f"[phase 24a: {time.perf_counter() - t0:.1f} s]")
    errs, figures, flash = {}, {}, {"per_prefill": 0, "total": 0}
    for arch in P24_LAYERS:
        t1 = time.perf_counter()
        run = p24_config(arch, report, card)
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in run["errs"].items():
            errs[k] = max(errs.get(k, 0.0), v)
        figures[arch] = run["figures"]
        flash["total"] += run["flash"]["total"]
        if arch == "qwen2-vl-72b":
            flash["per_prefill"] = run["flash"]["per_prefill"]
        report(f"[phase 24 {arch}: {time.perf_counter() - t1:.1f} s]")
    row = time_flash(checked, flash, name="flash_attention_hd128")
    row["launches_phase24"] = flash["total"]
    del checked
    free()
    return launches, errs, row, figures


# ---------------------------------------------------------------------------
# phase 25: distribution — the sharded train step, the compressed data-
# parallel step and the pipeline on a process group of one NCCL rank, and
# the launcher under the torchrun environment
# ---------------------------------------------------------------------------

P25_STEPS = 3         # the second timed, the third profiled
P25_DP_LAYERS = 2
P25_DP_BATCH, P25_DP_SEQ = 2, 2048
P25_LAUNCH = ["--arch", "stablelm-1.6b", "--model-shards", "1", "--steps",
              "3", "--batch", "2", "--seq", "2048", "--remat", "full",
              "--log-every", "1"]


def _to_host(tree):
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda x: x.to("cpu"), tree)


def _bits_equal(tree_a, tree_b) -> bool:
    """Every leaf of ``tree_a`` equal bit for bit to ``tree_b``'s, compared
    where ``tree_b``'s lies (a device tree against a host one: one leaf on
    the host at a time); a NaN equals nothing."""
    import torch
    from repro_torch.train.optimizer import tree_leaves
    a, b = tree_leaves(tree_a), tree_leaves(tree_b)
    return len(a) == len(b) and all(
        torch.equal(x.to(y.device), y) for x, y in zip(a, b))


def _nonfinite(tree) -> dict:
    """The count of non-finite elements under each top-level key of a
    result tree."""
    import torch
    return {k: sum(int((~torch.isfinite(x)).sum()) for x in _leaves_of(v))
            for k, v in tree.items()}


def p25_sharded(report, card) -> dict:
    """(a) StableLM-1.6B at its 24 layers on phase 21's cell (4 x 4096 in
    2 microbatches, remat full, bf16, the train table): three steps of
    ``build_train_step(mesh, rules)`` on ``make_host_mesh(model=1)`` of the
    one-rank NCCL group against three of the unsharded kernel step from
    the same weights — loss, grad norm and every parameter and moment bit
    for bit (the unsharded result held on the host); the control: one
    sharded step from the weights with one embedding row moved must move
    the loss.  Launches are counted over the sharded steps; the second of
    each run is the one timed, the sharded run's third is profiled."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.sharding.partition import make_rules
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import build_train_step, make_step_fn
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("stablelm-1.6b")
    shape = train_shape()
    mesh = make_host_mesh(model=1)
    rules = make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                       n_kv_heads=cfg.n_kv_heads)
    ec = shape_exec_config(cfg, shape, use_kernels=True, model_shards=1,
                           device="cuda")
    opt = AdamWConfig(lr=P21_LR, warmup_steps=1, total_steps=4)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device=dev)
    toks = torch.randint(0, cfg.vocab, (P21_BATCH, P21_SEQ + 1),
                         generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    tokens = P21_BATCH * P21_SEQ

    def steps(step, p, label, prof_step=None, n=P25_STEPS):
        st = init_opt_state(p)
        out, times, prof = [], [], None
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ops.exec_config(ec):
                if i == prof_step:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        p, st, m = step(p, st, batch)
                        torch.cuda.synchronize()
                else:
                    p, st, m = step(p, st, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            out.append((m["loss"].item(), m["grad_norm"].item()))
        report(f"  {label}: (loss, grad_norm) {out}; step times "
               f"{[round(1e3 * x, 1) for x in times]} ms")
        return p, st, out, times, prof

    torch.cuda.reset_peak_memory_stats()
    p_u, st_u, m_u, t_u, _ = steps(make_step_fn(cfg, shape, opt), params,
                                   "unsharded kernel step")
    host = _to_host({"p": p_u, "mu": st_u.mu, "nu": st_u.nu})
    del p_u, st_u
    free()
    peak_u = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    step = build_train_step(cfg, shape, opt, mesh, rules)
    reset_launches()
    p_s, st_s, m_s, t_s, prof = steps(step, params, "sharded step on "
                                      f"{mesh}", prof_step=2)
    launches = launch_counts()
    peak_s = torch.cuda.max_memory_allocated() / 2 ** 30
    need(m_s == m_u, f"phase 25 (a): sharded (loss, grad_norm) {m_s} != "
         f"unsharded {m_u}")
    need(_bits_equal({"p": p_s, "mu": st_s.mu, "nu": st_s.nu}, host),
         "phase 25 (a): a parameter or moment of the sharded step differs "
         "from the unsharded step's")
    for key in ("output", "flash_attention", "flash_backward"):
        need(launches[key] > 0, f"phase 25 (a): {key} never launched")
    del p_s, st_s, host
    free()
    # the control: one embedding row of the first token moved
    row = int(batch["tokens"][0, 0])
    params["embed"][row] += 0.5
    _, _, m_c, _, _ = steps(step, params, "control (one embedding row "
                            "moved)", n=1)
    need(m_c[0][0] != m_s[0][0], "phase 25 (a): the control's loss did not "
         "move")
    del params
    free()
    busy, n_kernels, fam = device_breakdown(prof)
    nccl = [(n, us) for n, us in device_events(prof) if "nccl" in n.lower()]
    nccl_ms = sum(us for _, us in nccl) / 1e3
    ms = 1e3 * t_s[1]
    report(f"  24 layers, {P21_BATCH} x {P21_SEQ} tokens a step in "
           f"{P21_MICRO} microbatches, remat full ({card}): sharded step "
           f"{ms:.1f} ms (the second; the unsharded second "
           f"{1e3 * t_u[1]:.1f}), {tokens / ms * 1e3:.0f} tokens/s; peak "
           f"{peak_s:.2f} GiB sharded, {peak_u:.2f} GiB unsharded; device "
           f"busy {busy / 1e3:.1f} ms over {n_kernels} kernels; NCCL "
           f"kernels {len(nccl)}, {nccl_ms:.3f} ms (a mesh of one rank "
           f"runs no collective); launches "
           f"{ {k: v for k, v in launches.items() if v} }")
    return dict(launches=launches, ms=ms, unsharded_ms=1e3 * t_u[1],
                tokens_per_s=tokens / ms * 1e3, peak_gib=peak_s,
                peak_unsharded_gib=peak_u, busy_ms=busy / 1e3,
                nccl_ms=nccl_ms, nccl_kernels=len(nccl),
                losses=[x for x, _ in m_s])


def p25_nccl(report, card) -> float:
    """The one-rank NCCL group itself: an all-reduce of 64 MiB (float32),
    which must leave the tensor as it was, timed with CUDA events."""
    import torch
    import torch.distributed as dist
    x = torch.randn(16 << 20, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    y = x.clone()
    dist.all_reduce(y)
    torch.cuda.synchronize()
    need(torch.equal(x, y), "phase 25: a one-rank all_reduce changed the "
         "tensor")
    ms = cuda_ms(lambda: dist.all_reduce(y), iters=10)
    report(f"  NCCL all_reduce of 64 MiB on the one-rank group: {ms:.4f} ms "
           f"({card})")
    return ms


def p25_dp(report) -> None:
    """(b) ``build_dp_compressed_step`` in int8 and zvc_topk on the
    one-rank mesh, StableLM-1.6B at full width cut to P25_DP_LAYERS
    layers, one microbatch of P25_DP_BATCH x P25_DP_SEQ under the train
    table: the update equal bit for bit to the composition in this process
    (the kernel gradients, quantize -> dequantize -> the mean of one, or
    the top-k mask, -> AdamW), the error-feedback state nonzero and equal
    to (gradient - what was kept)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.train import grad_compress as gc
    from repro_torch.train import train_step as step_lib
    from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                             init_opt_state, tree_leaves)

    cfg = dataclasses.replace(get_config("stablelm-1.6b"),
                              n_layers=P25_DP_LAYERS)
    shape = dataclasses.replace(train_shape(), global_batch=P25_DP_BATCH,
                                seq_len=P25_DP_SEQ, n_micro=1)
    ec = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
    opt = AdamWConfig(lr=P21_LR, warmup_steps=1, total_steps=4)
    mesh = make_host_mesh(model=1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device=dev)
    toks = torch.randint(0, cfg.vocab, (P25_DP_BATCH, P25_DP_SEQ + 1),
                         generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    with ops.exec_config(ec):
        loss, grads = step_lib.value_and_grad(
            step_lib.loss_for(cfg, shape), params, batch)
    for mode in ("int8", "zvc_topk"):
        t = time.perf_counter()
        step = step_lib.build_dp_compressed_step(
            cfg, shape, opt, mesh, gc.CompressConfig(mode=mode))
        with ops.exec_config(ec):
            new, _, err, m = step(params, init_opt_state(params),
                                  gc.init_error_state(params), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        kept, want_err = [], []
        for g in tree_leaves(grads):
            u = g.float() + torch.zeros(g.shape, dtype=torch.float32,
                                        device=dev)
            if mode == "int8":
                q, s = gc.quantize_int8(u)
                k = gc.dequantize_int8(q, s)
            else:
                flat = u.reshape(-1)
                thr = torch.topk(flat.abs(), max(int(flat.numel() * 0.05),
                                                 1)).values[-1]
                k = torch.where(u.abs() >= thr, u, torch.zeros_like(u))
            kept.append((k / 1).to(g.dtype))
            want_err.append(u - k)
        want, _, _ = adamw_update(opt, params, step_lib._unflatten(
            params, kept), init_opt_state(params))
        need(torch.equal(m["loss"], loss), f"phase 25 (b) {mode}: loss "
             f"{m['loss'].item()} != {loss.item()}")
        need(all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(new), tree_leaves(want))),
             f"phase 25 (b) {mode}: the update differs from the in-process "
             f"composition")
        need(all(torch.equal(a, b) for a, b in
                 zip(tree_leaves(err), want_err)),
             f"phase 25 (b) {mode}: the error feedback differs")
        nz = sum(int((e != 0).sum()) for e in tree_leaves(err))
        need(nz > 0, f"phase 25 (b) {mode}: the error-feedback state is 0")
        report(f"  DP {mode} step at {P25_DP_LAYERS} layers, "
               f"{P25_DP_BATCH} x {P25_DP_SEQ}: loss {loss.item():.6f}, "
               f"update == the composition bit for bit, {nz} nonzero "
               f"error-feedback elements; wall {wall:.2f} s")
        del new, err, want, kept, want_err
        free()
    del params, grads
    free()


def p25_pipeline(report) -> None:
    """(c) ``pipeline_apply`` with one stage (a "pod" axis of the one-rank
    group) on CUDA tensors: the reference's single-stage test (each layer
    adds its index: every output is the sum) and a tanh stack against the
    sequential loop, bit for bit."""
    import torch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding.pipeline import pipeline_apply, split_stages

    mesh = Mesh((1,), ("pod",))
    dev = torch.device("cuda")
    n_layers, d, b = 4, 8, 8
    stacked = {"w": torch.arange(n_layers, dtype=torch.float32,
                                 device=dev)[:, None].repeat(1, d)}
    out = pipeline_apply(lambda lp, h: h + lp["w"],
                         split_stages(stacked, 1),
                         torch.zeros(b, d, device=dev), mesh=mesh,
                         axis_name="pod", n_micro=2)
    need(bool((out == float(sum(range(n_layers)))).all()),
         "phase 25 (c): the single-stage pipeline is not the sum")
    gen = torch.Generator(device=dev).manual_seed(27)
    n_layers, d, b = 8, 256, 12
    tanh = {"w": torch.randn(n_layers, d, d, device=dev, generator=gen)
            * d ** -0.5, "b": torch.zeros(n_layers, d, device=dev)}
    x = torch.randn(b, d, device=dev, generator=gen)

    def layer(lp, h):
        return torch.tanh(h @ lp["w"] + lp["b"])
    ref = x
    for i in range(n_layers):
        ref = layer({k: v[i] for k, v in tanh.items()}, ref)
    got = pipeline_apply(layer, split_stages(tanh, 1), x, mesh=mesh,
                         axis_name="pod", n_micro=3)
    need(torch.equal(got, ref), "phase 25 (c): the single-stage pipeline "
         "differs from the sequential loop")
    report("  pipeline_apply, one stage on CUDA: the single-stage sum and "
           "an 8-layer tanh stack (3 microbatches) == the sequential loop "
           "bit for bit")


def p25_launcher(report, card) -> dict:
    """(d) ``python -m repro_torch.launch.train`` in a subprocess under the
    torchrun environment of a world of one (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, a free MASTER_PORT): the launcher initialises the NCCL
    group itself and trains the published 24 layers for 3 steps."""
    import socket
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        env["MASTER_PORT"] = str(sock.getsockname()[1])
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *P25_LAUNCH],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    need(proc.returncode == 0, f"phase 25 (d): the launcher exited "
         f"{proc.returncode}: {proc.stderr[-2000:]}")
    logs = [json.loads(x) for x in lines if x.startswith("{")]
    need([r["step"] for r in logs] == [1, 2, 3]
         and all(r["loss"] == r["loss"] for r in logs)
         and lines[-1].startswith("done: 3 steps"),
         f"phase 25 (d): launcher output {lines[-4:]}")
    report(f"  launcher under torchrun's environment (world 1, --model-shards"
           f" 1, {' '.join(P25_LAUNCH)}): {[(r['step'], r['loss'], round(1e3 * r['dt'], 1)) for r in logs]} "
           f"(step, loss, ms); wall {wall:.1f} s ({card})")
    return {"losses": [r["loss"] for r in logs], "wall_s": wall}


def run_distribution(report, card):
    """Phase 25: distribution on the card (the module docstring)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    free()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            rank=0, world_size=1)
    try:
        nccl_ms = p25_nccl(report, card)
        with expandable_segments():
            sharded = p25_sharded(report, card)
        report(f"[phase 25a: {time.perf_counter() - t0:.1f} s]")
        p25_dp(report)
        report(f"[phase 25b: {time.perf_counter() - t0:.1f} s]")
        p25_pipeline(report)
        report(f"[phase 25c: {time.perf_counter() - t0:.1f} s]")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    free()
    launcher = p25_launcher(report, card)
    report(f"[phase 25d: {time.perf_counter() - t0:.1f} s]")
    torch.cuda.synchronize()
    return {**sharded, "nccl_allreduce_64mib_ms": nccl_ms,
            "launcher": launcher}


# ---------------------------------------------------------------------------
# phase 26: expert parallelism and the sharded step of every family — the
# expert-parallel body at one NCCL rank against the local path and the
# plain route, the expert kernels at a 4-way expert-parallel rank's shapes,
# and the one-rank sharded step of each non-dense family against the
# unsharded kernel step
# ---------------------------------------------------------------------------

P26_EP = (  # (arch, batch, seq): one full-width MoE layer, bf16
    ("deepseek-moe-16b", 2, 4096),
    ("llama4-scout-17b-a16e", 2, 4096))
# a (1 x 4) mesh's rank under 2 x 4096 tokens: t_l = 2048, e_loc = E / 4,
# c_loc = int(t_l·k / e_loc · 1.25) + 1
P26_RANK_SHAPES = (("deepseek-moe-16b", 16, 961),
                   ("llama4-scout-17b-a16e", 4, 641))
P26_STEPS = (  # (arch, layers: None = published, seq, the whole step?)
    ("deepseek-moe-16b", 2, 4096, True),       # the dense first + one MoE
    ("llama4-scout-17b-a16e", 1, 4096, False),
    ("recurrentgemma-9b", 3, 4096, True),      # one Griffin group
    ("mamba2-1.3b", 1, 4096, True),            # phase 19's finite prefix
    ("whisper-tiny", None, 448, True),         # 2 x 1500 frames feed it
    ("qwen2-vl-72b", 1, 4096, False))
P26_LR = 3e-4


def _ep_leaves(p):
    return {k: p[k] for k in ("router", "experts_in", "experts_gate",
                              "experts_out")}


def _layer_grads(fn, p, x, gy, ec):
    """(y, {name: gradient}) of ``fn(p, x)`` against the cotangent ``gy``
    under ``ec`` (None: the plain route), for x and the routed leaves."""
    import torch
    from repro_torch.kernels import ops
    leaves = {k: v.detach().requires_grad_() for k, v in
              _ep_leaves(p).items()}
    xr = x.detach().requires_grad_()
    with ops.exec_config(ec or ops.ExecConfig()):
        y = fn(leaves, xr)
        names = ["x"] + list(leaves)
        grads = torch.autograd.grad(y, [xr] + list(leaves.values()), gy)
    torch.cuda.synchronize()
    return y.detach(), dict(zip(names, grads))


def p26_ep(report, card) -> dict:
    """(a) ``moe._apply_moe_ep`` on a one-rank mesh (ep = 1: every slot is
    sent and c_loc is the local path's capacity, so dispatch is the local
    path's) at one full-width MoE layer of each ``P26_EP`` config, bf16,
    the train table: the forward and the gradients of x and every routed
    leaf against ``_apply_moe_local`` — the expert leaves bit for bit, the
    output bit for bit at top-1 and within the combine's bound
    (2k + 1)·2⁻⁸·Σ_j|g_j·y_j| above it (the reference's combine adds the
    gate-weighted rows in the rows' dtype, one rounding a slot; the local
    path sums in float32 and rounds once), the router and x within 2⁻⁶ of
    their largest element (the gate's gradient rounds to bf16 on the
    expert-parallel side; a top-1 gate is p / p = 1, so its router's
    gradient is rounding on both sides, held to 2⁻⁶ of the largest dx) —
    and against its plain route, routed as the kernels
    (``same_routing``), each within 2⁻⁵ of the plain value's largest (the
    top-1 router's of the largest dx).  The expert kernels' launches are
    counted over the expert-parallel call."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.sharding.partition import make_rules

    mesh = make_host_mesh(model=1)
    dev = torch.device("cuda")
    out = {}
    for arch, b, s in P26_EP:
        t0 = time.perf_counter()
        cfg = cut_config(arch, 2)
        m = cfg.moe
        d = cfg.d_model
        rules = make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        shape = dataclasses.replace(train_shape(), global_batch=b,
                                    seq_len=s, n_micro=1)
        ec = shape_exec_config(cfg, shape, use_kernels=True, device="cuda")
        gen = torch.Generator(device=dev).manual_seed(26)
        p = moe.init_moe(cfg, gen, torch.bfloat16)
        x = torch.randn((b, s, d), generator=gen, device=dev).bfloat16()
        gy = torch.randn((b, s, d), generator=gen, device=dev).bfloat16()

        def ep(lv, xr):
            return moe._apply_moe_ep(lv, cfg, xr, rules)

        def local(lv, xr):
            return moe._apply_moe_local(lv, cfg, xr.reshape(-1, d)).reshape(
                b, s, d)
        tape = {"idx": [], "flips": 0}
        reset_launches()
        with same_routing(tape, replay=False):
            y_ep, g_ep = _layer_grads(ep, p, x, gy, ec)
        launches = launch_counts()
        e_launch = launches["output"] + launches["output_experts"]
        need(e_launch >= 3 * m.n_experts, f"phase 26 (a) {arch}: "
             f"{e_launch} fm_output launches, fewer than one per expert and "
             f"expert site ({3 * m.n_experts})")
        y_lo, g_lo = _layer_grads(local, p, x, gy, ec)
        # the combine's magnitude: Σ_j |g_j · y_j| per element
        with torch.no_grad(), ops.exec_config(ec):
            xt = x.reshape(-1, d)
            gates, idx = moe._route(p["router"], xt, m.top_k)
            t, f = xt.shape[0], xt.shape[0] * m.top_k
            cap = moe._capacity(t, m.top_k, m.n_experts, m.capacity_factor)
            f_sel, valid = moe._dispatch_indices(idx.reshape(f), m.n_experts,
                                                 cap)
            xe = torch.where(valid[..., None], xt[f_sel // m.top_k],
                             torch.zeros((), dtype=x.dtype, device=dev))
            rows = moe._scatter_rows(f, f_sel, valid, moe._expert_ffn(xe, p))
            mag = (rows.float().abs().reshape(t, m.top_k, d)
                   * gates.to(x.dtype).float()[..., None]).sum(1)
            del xe, rows
        err_y = (y_ep.float() - y_lo.float()).abs().reshape(t, d)
        if m.top_k == 1:
            need(torch.equal(y_ep, y_lo), f"phase 26 (a) {arch}: top-1 "
                 f"expert-parallel output differs from the local path's")
        else:
            bound = (2 * m.top_k + 1) * 2.0 ** -8 * mag
            need(bool((err_y <= bound).all()), f"phase 26 (a) {arch}: "
                 f"output {(err_y - bound).max().item()} over the combine's "
                 f"bound")
        errs = {"y": err_y.max().item()}
        for name in g_ep:
            diff = (g_ep[name].float() - g_lo[name].float()).abs().max()
            errs[name] = diff.item()
            if name.startswith("experts"):
                need(torch.equal(g_ep[name], g_lo[name]), f"phase 26 (a) "
                     f"{arch}: d{name} differs from the local path's")
            elif name == "router" and m.top_k == 1:
                # a top-1 gate is p / p = 1: the router's gradient is zero
                # but for rounding on both sides, held to the layer's scale
                top = max(g_ep[name].float().abs().max().item(),
                          g_lo[name].float().abs().max().item())
                scale = g_lo["x"].float().abs().max().item()
                need(top <= 2.0 ** -6 * scale, f"phase 26 (a) {arch}: "
                     f"top-1 drouter {top} over 2^-6 of max |dx| {scale}")
            else:
                scale = g_lo[name].float().abs().max().item()
                need(errs[name] <= 2.0 ** -6 * scale, f"phase 26 (a) {arch}"
                     f": d{name} {errs[name]} over 2^-6 of {scale}")
        del y_lo, g_lo
        with same_routing(tape, replay=True):
            y_pl, g_pl = _layer_grads(ep, p, x, gy, None)
        plain = {"y": ((y_ep.float() - y_pl.float()).abs().max().item(),
                       y_pl.float().abs().max().item())}
        for name in g_pl:
            plain[name] = ((g_ep[name].float() - g_pl[name].float()).abs()
                           .max().item(),
                           g_pl[name].float().abs().max().item())
        for name, (e, scale) in plain.items():
            if name == "router" and m.top_k == 1:
                scale = plain["x"][1]       # rounding on both sides, as above
            need(e <= 2.0 ** -5 * scale, f"phase 26 (a) {arch}: {name} "
                 f"{e} from the plain route, over 2^-5 of {scale}")
        report(f"  {arch} MoE layer (E {m.n_experts}, top-{m.top_k}, d {d},"
               f" ff {m.expert_d_ff}), {b} x {s} tokens, bf16: expert-"
               f"parallel vs local max |diff| "
               f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } "
               f"(expert leaves bit for bit"
               f"{', output bit for bit' if m.top_k == 1 else ''}); vs the "
               f"plain route (routed as the kernels; it would route "
               f"{tape['flips']} of {t} tokens otherwise) "
               f"{ {k: float(f'{v[0]:.3e}') for k, v in plain.items()} }; "
               f"fm_output launches {e_launch} "
               f"[{time.perf_counter() - t0:.1f} s] ({card})")
        out[arch] = dict(launches=launches, err_local=errs,
                         err_plain={k: v[0] for k, v in plain.items()},
                         flips=tape["flips"])
        del p, x, gy, y_ep, g_ep, y_pl, g_pl, tape
        free()
    return out


def p26_rank_kernels(report, ep_out) -> list:
    """(b) The expert kernels at a 4-way expert-parallel rank's shapes
    (``P26_RANK_SHAPES``, experts_in's product (e_loc, c_loc, d) @
    (e_loc, d, ff), bf16): forward, dX and dW of ``ops.flex_expert_matmul``
    under autograd and the train table against autograd of the plain
    float32 batched product, within ``expert_tols`` plus one bf16 step of
    the value; each product timed (CUDA events and a captured graph)
    beside its bound, the plain version and ``torch.bmm``.  Returns the
    ``kernels`` rows."""
    import torch
    from repro_torch.kernels import flex_matmul as fm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import expert_matmul_ref
    from repro_torch.serve.engine import shape_exec_config

    saved = launch_counts()
    rows = []
    dev = torch.device("cuda")
    for arch, e, c in P26_RANK_SHAPES:
        cfg = cut_config(arch, 2)
        d, f = cfg.d_model, cfg.moe.expert_d_ff
        ec = shape_exec_config(cfg, train_shape(), use_kernels=True,
                               device="cuda")
        gen = torch.Generator(device=dev).manual_seed(261)
        x = torch.randn((e, c, d), generator=gen, device=dev).bfloat16()
        w = (torch.randn((e, d, f), generator=gen, device=dev)
             * d ** -0.5).bfloat16()
        g = torch.randn((e, c, f), generator=gen, device=dev).bfloat16()
        xk, wk = (t.clone().requires_grad_() for t in (x, w))
        with ops.exec_config(ec):
            yk = ops.flex_expert_matmul(xk, wk, site="moe.experts_in")
        yk.backward(g)
        xp, wp = (t.clone().requires_grad_() for t in (x, w))
        yp = torch.matmul(xp.float(), wp.float()).to(torch.bfloat16)
        yp.backward(g)
        wt = w.transpose(-1, -2)
        xt = x.transpose(-1, -2).contiguous()
        errs = {}
        for label, got, want, (a, b_) in (
                ("fwd", yk, yp, (x, w)), ("dx", xk.grad, xp.grad, (g, wt)),
                ("dw", wk.grad, wp.grad, (xt, g))):
            tol = expert_tols(a, b_)
            err = (got.float() - want.float()).abs()
            bound = tol + 2.0 ** -7 * torch.maximum(want.float().abs(),
                                                    got.float().abs())
            need(bool((err <= bound).all()), f"phase 26 (b) {arch} {label}:"
                 f" {(err - bound).max().item()} over expert_tols + one bf16"
                 f" rounding")
            errs[label] = err.max().item()
        del xk, wk, xp, wp, yk, yp
        for label, a, b_ in (("fwd", x, w), ("dx", g, wt), ("dw", xt, g)):
            m_, k_, n_ = a.shape[1], a.shape[2], b_.shape[2]
            b_ms, b_by = bound_ms((a.numel() + b_.numel()) * 2
                                  + e * m_ * n_ * 4, 2.0 * e * m_ * k_ * n_)

            def kcall(a=a, b_=b_):
                return fm.flex_matmul(a, b_, out_dtype=torch.float32)
            row = {
                "name": f"flex_output_experts_ep4_{arch.split('-')[0]}_"
                        f"{label}",
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flex_matmul.cu",
                "replaces": "src/repro/kernels/flex_matmul.py:52",
                "launches": ep_out[arch]["launches"]["output"],
                "max_abs_err": errs[label],
                "ms": cuda_ms(kcall, iters=5),
                "plain_ms": cuda_ms(lambda a=a, b_=b_: expert_matmul_ref(
                    a, b_), iters=2),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(lambda a=a, b_=b_: torch.bmm(a, b_),
                                      iters=5),
                "device_ms": device_ms(kcall, calls=3),
                "shape": [e, m_, k_, n_],
                "note": f"fm_output over a 4-way expert-parallel rank's "
                        f"{e} experts of {arch} (c_loc {c}), experts_in's "
                        f"{label}; launches: fm_output launches of phase 26 "
                        f"(a)'s expert-parallel {arch} layer"}
            rows.append(row)
            report(f"  {row['name']} {row['shape']}: {row['ms']:.3f} ms "
                   f"(device {row['device_ms']}), bound {b_ms:.3f} "
                   f"({b_by}), bmm {row['library_ms']:.3f}, plain "
                   f"{row['plain_ms']:.3f}; max |err| {errs[label]:.3e}")
        del x, w, g, wt, xt
        free()
    reset_launches(saved)
    return rows


def p26_batch(cfg, b, seq):
    """The launcher's batch of a config on the card: tokens, next-token
    labels and the data pipeline's frontend stubs (a vision prefix and
    M-RoPE streams); an encoder-decoder's 30 s of frames as phase 22's."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import with_frontend_inputs
    from repro_torch.models import model as model_lib
    if cfg.encoder_decoder:
        return p22_batch(cfg, b, seq, seed=26)
    rng = np.random.default_rng(26)
    toks = rng.integers(0, cfg.vocab, (b, seq + 1))
    raw = {"tokens": np.ascontiguousarray(toks[:, :-1]),
           "labels": np.ascontiguousarray(toks[:, 1:])}
    raw = with_frontend_inputs(raw, cfg, n_vis=model_lib.n_vis(cfg, seq))
    return {k: torch.as_tensor(v, device="cuda") for k, v in raw.items()}


P26_TIMED = 3       # timed calls a side, alternating, after the compared


def p26_steps(report, card) -> dict:
    """(c) Each non-dense family at full width and cut depth
    (``P26_STEPS``), 2 x 4096 tokens in 2 microbatches (whisper-tiny 2 x
    448 over 2 x 1500 frames), remat full, bf16, the train table: the
    sharded step on ``make_host_mesh(model=1)`` of the one-rank NCCL group
    against the unsharded kernel step from the same weights, loss, grad
    norm and every parameter and moment bit for bit, and every one of them
    finite on both sides (the count of non-finite elements of each tree
    is reported; a NaN equals nothing).  The vision configs run at one
    layer and compare the step's gradients (``build_grad_fn``) bit for
    bit: at 2 layers they hold 4.2 B and 6.5 B parameters, whose AdamW
    update (float32 moments, old and new, ~24 bytes a parameter) does not
    fit 80 GB, and at one layer (3.4 B, 4.3 B) the unsharded gradients
    stay on the card beside the sharded run.  The compared calls come
    first and are not timed; then ``P26_TIMED`` calls a side, unsharded
    and sharded alternating, each result dropped at once and the
    allocator's cache kept (emptied, the next call would pay its
    regrowth): ms a step is the median of a side's.  The peak is the
    compared sharded call's own (what was held before it, the first
    call's garbage collected, not counted; the weights counted).
    Launches are counted over the compared sharded call.  Returns per
    arch ms and peak GiB."""
    import gc
    import statistics

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import shape_exec_config
    from repro_torch.sharding.partition import make_rules
    from repro_torch.train import train_step as step_lib
    from repro_torch.train.optimizer import AdamWConfig

    mesh = make_host_mesh(model=1)
    opt = AdamWConfig(lr=P26_LR, warmup_steps=1, total_steps=4)
    dev = torch.device("cuda")
    out, total = {}, None
    for arch, layers, seq, whole in P26_STEPS:
        t0 = time.perf_counter()
        cfg = cut_config(arch, layers)
        shape = dataclasses.replace(train_shape(), global_batch=2,
                                    seq_len=seq, n_micro=2)
        ec = shape_exec_config(cfg, shape, use_kernels=True, model_shards=1,
                               device="cuda")
        rules = make_rules(mesh, kind="train", n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        params = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(26),
            dtype=torch.bfloat16, device=dev)
        weights = sum(v.nbytes for v in _leaves_of(params))
        n_params = sum(v.numel() for v in _leaves_of(params))
        batch = p26_batch(cfg, 2, seq)
        if whole:
            runs = (make_step_fn_of(step_lib.make_step_fn(cfg, shape, opt)),
                    make_step_fn_of(step_lib.build_train_step(
                        cfg, shape, opt, mesh, rules)))
        else:
            runs = tuple(_named_grads(step_lib.build_grad_fn(*args)) for args
                         in ((cfg, shape), (cfg, shape, mesh, rules)))

        def call(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ops.exec_config(ec):
                res = fn(params, batch)
            torch.cuda.synchronize()
            return res, 1e3 * (time.perf_counter() - t)

        free()
        first, _ = call(runs[0])
        free()            # the first call's garbage, else counted as held
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        got, _ = call(runs[1])
        launches = launch_counts()
        # the run's own peak: what was held before it (the weights, the
        # first run's result) subtracted, the weights added back
        peak = (torch.cuda.max_memory_allocated() - held + weights) / 2 ** 30
        bad = {"unsharded": _nonfinite(first), "sharded": _nonfinite(got)}
        need(not any(n for side in bad.values() for n in side.values()),
             f"phase 26 (c) {arch}: non-finite elements {bad}")
        need(_bits_equal(got, first), f"phase 26 (c) {arch}: the one-rank "
             f"sharded {'step' if whole else 'gradients'} differ from the "
             f"unsharded")
        loss = float(got["loss"])
        norm = float(got["grad_norm"]) if whole else None
        del got, first
        gc.collect()      # the cache kept: empty, it would regrow in a call
        times = ([], [])
        for _ in range(P26_TIMED):
            for side, fn in enumerate(runs):
                res, ms = call(fn)
                times[side].append(ms)
                del res
        ms_u, ms = (statistics.median(t) for t in times)
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        report(f"  {arch} at {cfg.n_layers} layers ({n_params / 1e9:.3f} B "
               f"parameters, bf16), 2 x {seq} tokens in 2 microbatches: "
               f"sharded {'step' if whole else 'gradients'} == unsharded bit"
               f" for bit (loss {loss!r}, grad norm {norm!r}; non-finite "
               f"elements {bad['sharded']}); median of {P26_TIMED} warm "
               f"calls a side, alternating: sharded {ms:.1f} ms, unsharded "
               f"{ms_u:.1f} (sharded {[round(x, 1) for x in times[1]]}, "
               f"unsharded {[round(x, 1) for x in times[0]]}); peak "
               f"{peak:.2f} GiB; launches "
               f"{ {k: v for k, v in launches.items() if v} } "
               f"[{time.perf_counter() - t0:.1f} s] ({card})")
        out[arch] = dict(ms=ms, unsharded_ms=ms_u, ms_all=times[1],
                         unsharded_ms_all=times[0], peak_gib=peak,
                         whole_step=whole, layers=cfg.n_layers, seq=seq,
                         params_b=n_params / 1e9, loss=loss, grad_norm=norm,
                         nonfinite=bad["sharded"])
        del params, batch, runs
        free()
    for key in ("output", "flash_attention", "flash_backward"):
        need(total[key] > 0, f"phase 26 (c): {key} never launched")
    return out, total


def _named_grads(grad_fn):
    """``grad_fn``'s (loss, gradients) as one tree."""
    def run(params, batch):
        loss, grads = grad_fn(params, batch)
        return {"loss": loss, "g": grads}
    return run


def make_step_fn_of(step):
    """A step from fresh moments as a function of (params, batch) with one
    result tree: the new parameters, moments and metrics."""
    from repro_torch.train.optimizer import init_opt_state

    def run(params, batch):
        p, st, m = step(params, init_opt_state(params), batch)
        return {"p": p, "mu": st.mu, "nu": st.nu,
                "loss": m["loss"], "grad_norm": m["grad_norm"]}
    return run


def run_expert_parallel(report, card):
    """Phase 26: expert parallelism and every family's sharded step on a
    one-rank NCCL group (the module docstring)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    free()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                            rank=0, world_size=1)
    try:
        ep = p26_ep(report, card)
        report(f"[phase 26a: {time.perf_counter() - t0:.1f} s]")
        rows = p26_rank_kernels(report, ep)
        report(f"[phase 26b: {time.perf_counter() - t0:.1f} s]")
        with expandable_segments():
            steps, launches = p26_steps(report, card)
        report(f"[phase 26c: {time.perf_counter() - t0:.1f} s]")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    free()
    torch.cuda.synchronize()
    return {"ep": ep, "steps": steps, "launches": launches}, rows


# ---------------------------------------------------------------------------
# phase 27: the dry-run and roofline tooling against the card — the
# sharded decode step at one NCCL rank bit-equal to the unsharded one,
# each traced StableLM cell's FLOPs and peak against its real step, and the
# CLIs
# ---------------------------------------------------------------------------

P27_CACHE = 32768        # decode_32k's cache rows
P27_BATCH = 4            # decode_32k's batch (128) cut to 4
P27_STEPS = 8
# (arch, layers) of (a): StableLM at 4 layers, the other families at 1-3
# (recurrentgemma's one group: two RG-LRU layers and its windowed attention)
P27_DECODE = (("stablelm-1.6b", 4), ("deepseek-moe-16b", 2),
              ("mamba2-1.3b", 2), ("recurrentgemma-9b", 3),
              ("whisper-tiny", 2))
P27_POS = (100, 5000, 20000, 32000)     # each row's first position
P27_BAND = (0.85, 1.15)                 # predicted peak / measured peak
P27_CLIS = (
    ("dryrun stablelm-1.6b@train_4k single",
     ["-m", "repro_torch.launch.dryrun", "--arch", "stablelm-1.6b",
      "--shape", "train_4k", "--mesh", "single"]),
    ("dryrun deepseek-moe-16b@decode_32k multi",
     ["-m", "repro_torch.launch.dryrun", "--arch", "deepseek-moe-16b",
      "--shape", "decode_32k", "--mesh", "multi"]),
    ("roofline stablelm-1.6b@train_4k",
     ["-m", "repro_torch.roofline.analysis", "--arch", "stablelm-1.6b",
      "--shape", "train_4k"]),
)


def p27_start_clis(workdir):
    """(c) Start the three CLIs, each in its own process (its own fake
    process group of 256 or 512 ranks, away from this process's NCCL
    group), writing under ``workdir``; ``p27_finish_clis`` joins them."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    procs = []
    for i, (name, argv) in enumerate(P27_CLIS):
        out = os.path.join(workdir, "dryrun" if "dryrun" in argv[1]
                           else "roofline")
        log = open(os.path.join(workdir, f"cli{i}.log"), "w")
        proc = subprocess.Popen([sys.executable, *argv, "--out", out],
                                cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT)
        procs.append((name, argv, out, proc, log, time.time()))
    return procs


def p27_finish_clis(procs, report, timeout=400.0) -> dict:
    """Join the CLIs (killed after ``timeout`` s), require exit 0 and read
    their records: GiB a rank, FLOPs, collective GiB, dominant term (the
    H100 roofline of the record's own numbers), wall."""
    from repro_torch.roofline.analysis import roofline_terms
    deadline = time.time() + timeout
    while (any(p[3].poll() is None for p in procs)
           and time.time() < deadline):
        time.sleep(0.2)
    out = {}
    try:
        for name, argv, odir, proc, log, t0 in procs:
            rc = proc.poll()
            if rc is None:
                proc.kill()
                proc.wait()
            log.close()
            # its log's last write: the process may have ended long before
            wall = os.path.getmtime(log.name) - t0
            with open(log.name) as f:
                tail = f.read()[-1500:]
            need(rc == 0, f"phase 27 (c): {name} exited {rc}: {tail}")
            arch, shape = argv[argv.index("--arch") + 1], argv[
                argv.index("--shape") + 1]
            if "dryrun" in argv[1]:
                mesh = argv[argv.index("--mesh") + 1]
                with open(os.path.join(odir, mesh,
                                       f"{arch}@{shape}.json")) as f:
                    rec = json.load(f)
                need(rec["ok"] and rec["fits_hbm"],
                     f"phase 27 (c): {name}: record {rec.get('ok')}, fits "
                     f"{rec.get('fits_hbm')}")
                metrics = {"flops": rec["cost"]["flops"],
                           "bytes": rec["cost"]["bytes accessed"],
                           "coll_wire": rec["collectives"]["wire_bytes"]}
                gib = rec["live_bytes_per_device"] / 2**30
            else:
                with open(os.path.join(odir, f"{arch}@{shape}.json")) as f:
                    rec = json.load(f)
                metrics = rec["metrics_per_device"]
                gib = None
            terms = roofline_terms(metrics)
            dominant = max(terms, key=terms.get)
            out[name] = {"gib_per_rank": gib, "flops": metrics["flops"],
                         "coll_gib": metrics["coll_wire"] / 2**30,
                         "dominant": dominant,
                         "terms_ms": {k: v * 1e3 for k, v in terms.items()},
                         "wall_s": round(wall, 1)}
            report(f"  (c) {name}: exit 0, "
                   + (f"{gib:.2f} GiB a rank, " if gib is not None else "")
                   + f"{metrics['flops']:.4e} FLOPs, "
                   f"{metrics['coll_wire'] / 2**30:.3f} collective GiB, "
                   f"dominant {dominant} ({terms[dominant] * 1e3:.1f} ms), "
                   f"wall {wall:.1f} s")
    finally:
        for *_, proc, log, _t in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    return out


def _p27_filled_state(cfg, dev, seed):
    """A decode state of ``P27_BATCH`` rows and ``P27_CACHE`` positions with
    every leaf drawn from N(0, 1) (a prefilled cache: caches, a Whisper
    memory, SSM and RG-LRU states)."""
    import torch
    from repro_torch.core.sparsity import iter_leaves
    from repro_torch.models import model as model_lib
    st = model_lib.init_decode_state(cfg, P27_BATCH, P27_CACHE,
                                     torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for _, leaf in iter_leaves(st):
        leaf.normal_(generator=gen)
    return st


def _launch_total() -> int:
    from repro_torch.kernels import block_sparse as bs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flex_matmul as fm
    return sum(sum(m.LAUNCHES.values()) for m in (fm, bs, fa))


def p27_decode(report) -> dict:
    """(a) Each ``P27_DECODE`` config at published width and cut depth,
    bf16, the decode table's kernels: ``P27_STEPS`` steps of the serve
    step under decode rules on the one-rank mesh, the caches' rows cut
    over ``model`` (SP) or not, against ``model.decode_step`` from the same
    weights and filled state — logits at every step and the whole state
    after the last, bit for bit; the sharded side must launch kernels."""
    import torch
    from repro_torch.core.sparsity import iter_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as model_lib
    from repro_torch.serve.engine import build_serve_step, decode_exec_config
    from repro_torch.sharding import partition
    from repro_torch.train.train_step import param_specs

    dev = torch.device("cuda")
    mesh = make_host_mesh(model=1)
    pos0 = torch.tensor(P27_POS, device=dev)
    out = {}
    for arch, layers in P27_DECODE:
        t0 = time.perf_counter()
        cfg = cut_config(arch, layers)
        params = model_lib.init_params(
            cfg, torch.Generator(device=dev).manual_seed(27),
            dtype=torch.bfloat16, device=dev)
        ec = decode_exec_config(cfg, P27_BATCH, use_kernels=True,
                                device="cuda")
        serve = build_serve_step(cfg)
        gen = torch.Generator(device=dev).manual_seed(270)
        tokens = torch.randint(0, cfg.vocab, (P27_STEPS, P27_BATCH, 1),
                               generator=gen, device=dev)
        for seq_shard in (False, True):
            rules = partition.make_rules(
                mesh, kind="decode", n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, seq_shard=seq_shard)
            specs = param_specs(cfg, rules)
            p = partition.shard_tree(params, specs, mesh)
            st_a = _p27_filled_state(cfg, dev, 27)
            st_b = _p27_filled_state(cfg, dev, 27)
            st_specs = partition.batch_shardings({"state": st_a}, mesh,
                                                 seq_shard=seq_shard)["state"]
            cache = partition.cache_axis(st_specs)
            rows = partition.batch_shardings({"tokens": tokens[0]},
                                             mesh)["tokens"][0]
            launched = 0
            for t in range(P27_STEPS):
                pos = pos0 + t
                before = _launch_total()
                with partition.use_rules(rules, specs, rows, cache), \
                        ops.exec_config(ec):
                    lg_a, st_a = serve(p, tokens[t], st_a, pos)
                launched += _launch_total() - before
                with ops.exec_config(ec):
                    lg_b, st_b = model_lib.decode_step(params, cfg,
                                                       tokens[t], st_b, pos)
                need(torch.equal(lg_a, lg_b),
                     f"phase 27 (a) {arch} seq_shard={seq_shard}: step {t}"
                     f" logits differ from the unsharded step")
                need(bool(torch.isfinite(lg_a).all()),
                     f"phase 27 (a) {arch}: non-finite logits")
            for (path, a), (_, b) in zip(iter_leaves(st_a),
                                         iter_leaves(st_b)):
                need(torch.equal(a, b), f"phase 27 (a) {arch} seq_shard="
                                        f"{seq_shard}: state {path} differs")
            need(launched > 0, f"phase 27 (a) {arch}: the sharded step "
                               f"launched no kernel")
            out[f"{arch}/{'sp' if seq_shard else 'tp'}"] = {
                "launches_a_step": launched // P27_STEPS, "cache": cache}
            del st_a, st_b, p
        report(f"  (a) {arch} ({cfg.n_layers} layers): the one-rank serve "
               f"step under decode rules == decode_step bit for bit, "
               f"{P27_STEPS} steps x {P27_BATCH} rows at positions "
               f"{P27_POS[0]}..{P27_POS[-1] + P27_STEPS - 1} of "
               f"{P27_CACHE}, SP off and on "
               f"({out[arch + '/tp']['launches_a_step']} launches a step); "
               f"{time.perf_counter() - t0:.1f} s")
        del params
        free()
    return out


def p27_cells():
    """(b) The three StableLM-1.6B cells cut to one card: phase 21's
    train cell (4 x 4096 tokens in 2 microbatches, remat full), prefill
    1 x 32768 tokens at ``cell_shape``'s chunks, decode_32k at batch 4."""
    from repro_torch.configs.cells import cell_shape
    return (("train_4k", train_shape()),
            ("prefill_32k", dataclasses.replace(
                cell_shape("stablelm-1.6b", "prefill_32k"), global_batch=1)),
            ("decode_32k", dataclasses.replace(
                cell_shape("stablelm-1.6b", "decode_32k"),
                global_batch=P27_BATCH)))


def _p27_args(step, dev):
    """Real inputs of a StableLM cell step (one-rank mesh: blocks are the
    whole leaves): weights from the port's init, AdamW's zero state,
    token batches drawn from a seed, a zero decode state, the last
    position of the cache."""
    import torch
    from repro_torch.models import model as model_lib
    from repro_torch.train.optimizer import init_opt_state
    cfg, shape = step.cfg, step.shape
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(27),
        dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(271)

    def tokens(*dims):
        return torch.randint(0, cfg.vocab, dims, generator=gen, device=dev,
                             dtype=torch.int32)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return (params, init_opt_state(params),
                {"tokens": tokens(b, s), "labels": tokens(b, s)})
    if shape.kind == "prefill":
        return params, {"tokens": tokens(b, s)}
    state = model_lib.init_decode_state(cfg, b, s, torch.bfloat16,
                                        device=dev)
    return (params, tokens(b, 1), state,
            torch.tensor(s - 1, dtype=torch.int32, device=dev))


def p27_predict(report) -> dict:
    """(b) For each ``p27_cells`` cell: ``trace_cell`` on fake CUDA
    tensors predicts the peak, the FLOPs and the roofline bound (H100
    datasheet constants; no collectives on one rank); then the same step
    runs for real from real inputs.  Gates: the traced FLOPs equal the
    real step's (``FlopCounterMode`` plus the kernel wrappers' counters,
    the same route), and predicted peak / measured peak lies in
    ``P27_BAND`` — the measured peak is ``max_memory_allocated`` after a
    reset, the inputs resident, less what the card held before the inputs
    were made.  Reported: the median of 3 warm calls against the bound
    (the fraction of the roofline reached)."""
    import gc
    import statistics

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import accounting
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.step_builders import build_cell_step, trace_cell
    from repro_torch.roofline.analysis import roofline_terms

    dev = torch.device("cuda")
    mesh = make_host_mesh(model=1)
    out = {}
    for name, shape in p27_cells():
        t0 = time.perf_counter()
        step = build_cell_step("stablelm-1.6b", name, mesh, shape=shape)
        tr = trace_cell(step)
        t_trace = time.perf_counter() - t0
        terms = roofline_terms({"flops": tr["flops"], "bytes": tr["bytes"],
                                "coll_wire": 0.0})
        dominant = max(terms, key=terms.get)
        bound_ms = terms[dominant] * 1e3

        free()
        base = torch.cuda.memory_allocated()
        base_req = torch.cuda.memory_stats().get(
            "requested_bytes.all.current", 0)
        args = _p27_args(step, dev)
        accounting.reset()
        with FlopCounterMode(display=False) as fc:
            res = step.fn(*args)
        torch.cuda.synchronize()
        flops = float(fc.get_total_flops()) + accounting.totals()["flops"]
        del res
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        res = step.fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        # the bytes asked for, before the allocator rounds them to blocks
        requested = torch.cuda.memory_stats().get(
            "requested_bytes.all.peak", 0) - base_req
        del res
        gc.collect()
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            res = step.fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            del res
        ms = statistics.median(times)
        predicted = tr["memory"]["peak_bytes"]
        ratio = predicted / peak
        report(f"  (b) stablelm-1.6b@{name} (B {shape.global_batch}, S "
               f"{shape.seq_len}, n_micro {shape.n_micro}): traced in "
               f"{t_trace:.1f} s; FLOPs traced {tr['flops']:.6e}, counted "
               f"{flops:.6e}; peak predicted {predicted / 2**30:.3f} GiB, "
               f"measured {peak / 2**30:.3f} GiB (ratio {ratio:.4f}; "
               f"requested {requested / 2**30:.3f} GiB); "
               f"bound {bound_ms:.3f} ms ({dominant}), median of 3 warm "
               f"calls {ms:.3f} ms ({', '.join(f'{t:.1f}' for t in times)})"
               f" -> {bound_ms / ms:.4f} of the roofline")
        need(tr["flops"] == flops, f"phase 27 (b) {name}: traced FLOPs "
             f"{tr['flops']} != counted {flops}")
        need(P27_BAND[0] <= ratio <= P27_BAND[1],
             f"phase 27 (b) {name}: predicted / measured peak {ratio:.4f} "
             f"outside {P27_BAND}")
        out[name] = {"flops": flops, "predicted_peak_gib": predicted / 2**30,
                     "peak_gib": peak / 2**30, "peak_ratio": ratio,
                     "requested_peak_gib": requested / 2**30,
                     "bytes_upper": tr["bytes"], "bound_ms": bound_ms,
                     "bound_by": dominant, "ms": ms, "ms_calls": times,
                     "roofline_fraction": bound_ms / ms}
        del args
        free()
    return out


def run_tooling(report, card):
    """Phase 27: the sharded decode step, the traces held against the card
    and the CLIs (the module docstring); the CLIs run in their own
    processes while (a) and the traces of (b) run here."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    free()
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "p27")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    procs = p27_start_clis(work)
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    try:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            decode = p27_decode(report)
            report(f"[phase 27a: {time.perf_counter() - t0:.1f} s]")
            predict = p27_predict(report)
            report(f"[phase 27b: {time.perf_counter() - t0:.1f} s]")
        finally:
            dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        clis = p27_finish_clis(procs, report)
    report(f"[phase 27c: {time.perf_counter() - t0:.1f} s]")
    torch.cuda.synchronize()
    return {"card": card, "decode": decode, "predict": predict,
            "clis": clis, "seconds": round(time.perf_counter() - t0, 1)}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the whole report, which outgrows what a caller keeps of the output
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    log_file = open(os.path.join(ROOT, "build", "chip_smoke.log"), "w")

    def report(msg):
        print(msg, flush=True)
        log_file.write(msg + "\n")
        log_file.flush()

    try:
        t_start = time.perf_counter()
        t_phase = [t_start]

        def done(label):
            now = time.perf_counter()
            report(f"[{label}: {now - t_phase[0]:.1f} s]")
            t_phase[0] = now

        # phase 1: the card
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        card = smi[0] if smi else name
        report(f"device: {name}, torch {torch.__version__}, "
               f"CUDA {torch.version.cuda}")
        # phase 2: build
        from repro_torch.kernels import build
        secs = build.build_all()
        report(f"kernel build: {secs:.1f} s")
        for lib, log in build.BUILD_LOG.items():
            for line in log.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry function" in line):
                    report(f"  [{lib}] {line.strip()}")
        check_tensor_cores(build, report)
        check_backward_kernels(build, report)
        done("phases 1-2")
        # phase 3: bring-up, then the kernels vs plain versions
        cfg, sp_cfg, params, planned, dense = bring_up(report)
        checked = check_sites(params, planned, dense, report)
        done("phase 3")
        # phases 4-5: the engines
        launches, bf16 = run_engines(cfg, params, planned, dense, report)
        rows = time_kernels(checked, launches)
        done("phases 4-5")
        # phase 6: int8 bring-up and the int8 kernels vs plain versions
        from repro_torch.serve.engine import (decode_exec_config,
                                              shape_exec_config)
        t0 = time.perf_counter()
        q8 = decode_exec_config(sp_cfg, N_SLOTS, params=params,
                                quantize=True, device="cuda")
        dense8 = decode_exec_config(cfg, N_SLOTS, use_kernels=True,
                                    quantize=True, device="cuda")
        torch.cuda.synchronize()
        report(f"int8 plan bring-up: {time.perf_counter() - t0:.1f} s; "
               f"weight-block skip fraction "
               f"{q8.plan.block_skip_fraction():.4f}")
        report(q8.schedules.describe())
        checked8 = check_sites_int8(cfg, params, q8, report)
        done("phase 6")
        # phase 7: the int8 engines
        launches8 = run_int8_engines(cfg, params, q8, dense8, bf16, report)
        # phase 8: the decode kernels' rows
        rows += time_int8_kernels(checked8, launches8)
        done("phases 7-8")
        # phase 23 on StableLM-1.6B: the serve executables
        executables = {cfg.name: run_executables(cfg, params, planned, q8,
                                                 bf16, report, card)}
        done("phase 23 (StableLM-1.6B)")
        del q8, dense8
        # phase 9: the prefill-shaped kernel checks
        shape = prefill_shape(report)
        t0 = time.perf_counter()
        dense_pf = shape_exec_config(cfg, shape, use_kernels=True,
                                     device="cuda")
        planned_pf = shape_exec_config(sp_cfg, shape, use_kernels=True,
                                       params=params, device="cuda")
        torch.cuda.synchronize()
        report(f"prefill table and plan bring-up: "
               f"{time.perf_counter() - t0:.1f} s")
        report(dense_pf.schedules.describe())
        report(planned_pf.schedules.describe())
        flash = check_flash(report)
        mm_errs, pf_times = check_prefill_sites(params, planned_pf, dense_pf,
                                                report)
        report(f"prefill-shape matmul worst errors: {mm_errs}")
        done("phase 9")
        # phase 10: bf16 prefill
        pf = run_prefill(cfg, params, dense_pf, planned_pf, shape, report)
        del dense_pf, planned_pf
        done("phase 10")
        # phase 11: int8 prefill
        total8, pf_times8, pf_errs8 = run_int8_prefill(
            cfg, sp_cfg, params, shape, pf["batch"], report)
        pf["total"] += total8
        done("phase 11")
        # phase 12: the kernels line (the matmul rows' times at prefill
        # mlp.in and worst errors at the prefill shape from phases 9 and
        # 11; fm_weight's launches in phase 10's all-weight-stationary
        # prefill beside those of phases 4-5)
        for row in rows:
            key = {"block_sparse": "block_sparse", "flex_output": "output",
                   "flex_weight": "weight",
                   "flex_input": "input"}.get(row["name"])
            if key is not None:
                row.update(prefill_ms=pf_times[key][0],
                           prefill_bound_ms=pf_times[key][1],
                           prefill_library_ms=pf_times["library"],
                           max_abs_err=max(row["max_abs_err"],
                                           mm_errs[key]))
            elif row["name"] in pf_times8:
                # no library time at prefill: torch._weight_int8pack_mm is
                # a kernel for a few rows, not for M = 8192
                row.update(prefill_ms=pf_times8[row["name"]][0],
                           prefill_bound_ms=pf_times8[row["name"]][1],
                           prefill_library_ms=None,
                           prefill_bf16_matmul_ms=pf_times8["bf16_matmul"],
                           max_abs_err=max(row["max_abs_err"],
                                           pf_errs8[row["name"]]))
            if row["name"] == "flex_weight":
                row.update(launches_ws_prefill=pf["ws_prefill"],
                           prefill_dataflow_bound_ms=pf_times["dataflow"][
                               "weight"])
            elif row["name"] == "flex_input":
                df = pf_times["dataflow"]
                row.update(launches_is_prefill=pf["is_prefill"],
                           prefill_dataflow_bound_ms=df["input"],
                           prefill_dataflow_rows=df["input_rows"],
                           prefill_dataflow_bound_128rows_ms=df["input_128"])
        rows.append(time_flash(flash, pf))
        done("phase 12")
        # phase 13: the full engine
        launches13 = run_full_engine(cfg, params, planned, dense, report,
                                     card)
        for row in rows:
            key = {"block_sparse": "block_sparse",
                   "flex_output": "output"}.get(row["name"])
            if key is not None:
                row.update(launches_phase13=launches13[key],
                           launches_sum_phase13=launches13[f"{key}_sum"])
        done("phase 13")
        # phase 14: plan tiers and self-speculative decoding
        launches14 = run_speculative(cfg, params, planned, dense,
                                     p13_traffic(cfg), report, card)
        for row in rows:
            key = {"block_sparse": "block_sparse",
                   "block_sparse_scaled": "block_sparse_scaled",
                   "flex_output": "output"}.get(row["name"])
            if key is not None:
                row.update(launches_phase14=launches14[key],
                           launches_sum_phase14=launches14[f"{key}_sum"])
        done("phase 14")
        # phase 15: the MoE family at full width (StableLM's weights freed)
        del params, planned, dense, checked, checked8, bf16, flash, pf
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        report(f"memory before phase 15: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        launches15, rows15, executables[P15_ARCH] = run_moe(report, card)
        for row in rows:
            key = {"block_sparse": "block_sparse",
                   "block_sparse_scaled": "block_sparse_scaled",
                   "flex_output": "output"}.get(row["name"])
            if key is not None:
                row.update(launches_phase15=launches15[key],
                           launches_sum_phase15=launches15[f"{key}_sum"])
        for row in rows15:
            row["launches_phase15"] = row["launches"]
        rows += rows15
        done("phase 15")
        # phases 16-17: yi-9b, gemma-2b (with int8 and the hd-256 prefill)
        # and chatglm3-6b, then recurrentgemma-9b, one config at a time
        free()
        flash_rows, launches16, errs16 = [], {}, {}
        for arch in P16_ARCHS:
            launches16[arch], errs16[arch] = run_family(arch, report, card,
                                                        flash_rows)
        done("phase 16")
        launches17, errs17 = run_family(P17_ARCH, report, card, flash_rows)
        done("phase 17")
        for row in rows:
            key = {"block_sparse": "block_sparse", "flex_output": "output",
                   "flex_weight": "weight", "flex_input": "input",
                   "block_sparse_scaled": "block_sparse_scaled",
                   "int8_matmul": "int8_matmul"}.get(row["name"])
            if key is None:
                continue
            err16 = max(e.get(key, 0.0) for e in errs16.values())
            err17 = errs17.get(key, 0.0)
            row.update(max_abs_err_phase16=err16, max_abs_err_phase17=err17,
                       max_abs_err=max(row["max_abs_err"], err16, err17))
            if key in ("weight", "input"):
                continue              # forced only: not on these paths
            row.update(
                launches_phase16=sum(n.get(key, 0)
                                     for n in launches16.values()),
                launches_phase17=launches17.get(key, 0))
        for row in flash_rows:
            row["launches_phase16_17"] = row["launches"]
        rows += flash_rows
        # phase 18: the analytic core, the ZVC codec, sparse dispatch off
        launches18, analytic = run_analytic(report)
        for row in rows:
            key = {"block_sparse": "block_sparse",
                   "flex_output": "output"}.get(row["name"])
            if key is not None:
                row["launches_phase18"] = launches18[key]
        done("phase 18")
        # phases 19-20: the SSM family and the Whisper encoder-decoder
        launches19, err19 = run_ssm(report, card)
        done("phase 19")
        launches20, errs20 = run_whisper(report, card)
        done("phase 20")
        # phase 21: training
        free()
        report(f"memory before phase 21: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
               f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        full21, rows21 = run_training(report, card)
        done("phase 21")
        for row in rows:
            key = {"block_sparse": "block_sparse", "flex_output": "output",
                   "flex_weight": "weight", "flex_input": "input",
                   "block_sparse_scaled": "block_sparse_scaled",
                   "int8_matmul": "int8_matmul",
                   "flash_attention": "flash_attention"}.get(row["name"])
            if key is None:
                continue
            # the errors only of kernels the phase compared
            if key == "output":
                row["max_abs_err_phase19"] = err19
            if key in errs20:
                row["max_abs_err_phase20"] = errs20[key]
            row.update(max_abs_err=max(row["max_abs_err"], err19 if key ==
                                       "output" else 0.0, errs20.get(key, 0.0)),
                       launches_phase19=launches19[key],
                       launches_phase20=launches20[key],
                       launches_phase21=full21["launches"][key])
        rows += rows21
        # phase 22: the other families train
        free()
        report(f"memory before phase 22: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
               f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        full22, rows22 = run_families_training(report, card)
        done("phase 22")
        for row in rows:
            key = {"flex_output": "output",
                   "flash_attention": "flash_attention"}.get(row["name"])
            if key is not None:
                row["launches_phase22"] = sum(
                    r["launches"][key] for r in full22.values())
        rows += rows22
        # phase 25: distribution on a one-rank NCCL group
        free()
        report(f"memory before phase 25: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
               f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        distribution = run_distribution(report, card)
        done("phase 25")
        for row in rows:
            key = {"flex_output": "output",
                   "flash_attention": "flash_attention",
                   "flash_backward": "flash_backward",
                   "flex_output_backward_dx": "output",
                   "flex_output_backward_dw": "output"}.get(row["name"])
            if key is not None:
                row["launches_phase25"] = distribution["launches"][key]
        # phase 26: expert parallelism and every family's sharded step
        free()
        report(f"memory before phase 26: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
               f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        expert_parallel, rows26 = run_expert_parallel(report, card)
        done("phase 26")
        for row in rows:
            key = {"flex_output": "output",
                   "flash_attention": "flash_attention",
                   "flash_backward": "flash_backward",
                   "flex_output_backward_dx": "output",
                   "flex_output_backward_dw": "output"}.get(row["name"])
            if key is not None:
                row["launches_phase26"] = expert_parallel["launches"][key]
        rows += rows26
        # phase 24: the serving CLI, Qwen2-VL-72B and Llama-4-Scout
        free()
        report(f"memory before phase 24: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
               f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        launches24, errs24, flash24, last_configs = run_last_configs(
            report, card)
        done("phase 24")
        for row in rows:
            key = {"block_sparse": "block_sparse", "flex_output": "output",
                   "flex_weight": "weight", "flex_input": "input",
                   "block_sparse_experts": "block_sparse_experts",
                   "flex_output_experts": "output_experts"}.get(row["name"])
            if key is None:
                continue
            if key in errs24:
                row.update(max_abs_err_phase24=errs24[key],
                           max_abs_err=max(row["max_abs_err"],
                                           errs24[key]))
            if key in launches24:
                row["launches_phase24"] = launches24[key]
        rows.append(flash24)
        # phase 27: the dry-run and roofline tooling against the card
        free()
        report(f"memory before phase 27: "
               f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
               f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
        tooling = run_tooling(report, card)
        done("phase 27")
        report(f"smoke wall time: {time.perf_counter() - t_start:.1f} s")
        for line in smi:
            report(line)
        report(json.dumps({"analytic": analytic}))
        report(json.dumps({"executables": executables}))
        report(json.dumps({"last_configs": last_configs}))
        report(json.dumps({"distribution": {
            k: v for k, v in distribution.items() if k != "launches"}}))
        report(json.dumps({"expert_parallel": {
            "ep": {a: {k: v for k, v in r.items() if k != "launches"}
                   for a, r in expert_parallel["ep"].items()},
            "steps": expert_parallel["steps"]}}))
        report(json.dumps({"tooling": tooling}))
        report(json.dumps({"kernels": rows}))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        log_file.write(f"FAILED: {exc}\n")
        return 1
    finally:
        log_file.close()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
