"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each failing the run on error:

1. print the card's name and power limit; build the port's CUDA kernels
   from ``src/repro_torch/csrc`` into ``build/kernels``, one ``nvcc`` per
   source, all started together; print each kernel's registers and spills
   (``-Xptxas -v``) and, where ``cuobjdump`` is there, the integer-ALU
   instructions that stochastic rounding adds to B1's SASS and the
   instructions per element in the loop of B2's SASS;
2. hold both passes of the fused 4-bit AdamW step (B1) against their plain
   torch versions on the card, round-to-nearest and stochastic rounding,
   at every shape the training path gives them: ``wo`` (24, 16, 128,
   2048), ``w1`` and ``w3`` (24, 2048, 8192), ``w2`` (24, 8192, 2048).
   The stats pass's per-dim stats, the update pass's codes and scales must
   be bit-equal, params within 1e-6 relative (both round every operation
   alike). Then time, with CUDA events (median) and the SM clock printed
   beside them, the stats pass and the torch prepass it replaces, the
   update pass (RTN and SR) and its plain version at each shape, each
   against its bound, and sum the four leaves of one step;
3. hold the block-wise 4-bit quantize (B2) and dequantize (B3) kernels
   against their plain versions at every q4 leaf shape of internlm2-1.8b,
   full size, each input holding a zero block, a NaN block and blocks out of
   B2's fast division (a scale above 2^60, a subnormal element): B2's codes
   and scales bit-equal from fp32 and from bf16 input, B3's output
   bit-equal. Time both with CUDA events (``kernels/timing.py``): one
   launch per event pair, median of 21, as phase 2 and earlier runs time
   kernels (the host's time per wrapper call falls inside); beside it 20
   back-to-back launches, median of 5, where that time hides; plain median
   of 3. Report GB/s, the share of 3.35 TB/s and the byte bound (4.53125 B per
   element), and B2's issue floor (its SASS instructions per element at 4
   warp instructions per SM and clock), per leaf and summed over the tree's
   11 leaves;
4. check the card against the CPU on a small input: three reduced-config
   production4bit steps from the same weights. Losses must agree within
   3e-4 relative (measured gap 3.2e-5: bf16 products round differently),
   a gap that the same model without its optimizer steps must exceed five
   times over, and at least 90% of the fused leaves' 4-bit first-moment
   codes must agree;
5. check q4 serving on the card against the CPU on a small input: the
   reduced config's q4 trees bit-equal (B2 on the card, its plain version on
   the CPU), prefill and teacher-forced decode logits within 2e-2 absolute
   (bf16 products again), and the agreement of greedy and sampled engine
   streams recorded;
6. drive the training path: ``repro_torch.launch.train`` trains
   internlm2-1.8b at full width and depth, production4bit with SR, 5 steps
   of batch 8 x seq 128, with every kernel launch count set to 0 just before
   and read just after; check state bytes (4,590,578,552), 4 launches of
   each B1 pass per step and none of B2/B3, the losses against the earlier
   runs' (to four decimals: codes and scales are bit-equal) and a last loss
   below the first, and report peak memory;
7. split one more full-size step into model and optimizer time (CUDA
   events) and list its top device kernels (``torch.profiler``);
8. drive the serving path: ``repro_torch.launch.serve`` serves
   internlm2-1.8b at full width and depth with q4 weights, 8 requests
   (prompt lengths from seed 0 in 32..384, half greedy, half T 0.8 top-k
   40) through 4 slots, 64 new tokens each, 8 decode steps per host sync,
   1024 cache slots, with every launch count set to 0 just before and read
   just after; check weight bytes (1,003,596,800), 11 B2 launches, 11 B3
   launches per prefill and per decode chunk, no B1, every stream complete
   and in the vocabulary; report prefill and decode device ms (CUDA
   events), tok/s and peak memory;
9. list the top device kernels of one decode chunk (``torch.profiler``);
10. checkpoint and resume in one process, on phase 37's configuration
    (internlm2-1.8b at full width and 2 of its 24 layers, production4bit
    with SR seed 0, batch 8 x seq 128, ``--steps 3 --ckpt-every 2
    --keep-last 1`` into ``build/ckpt_smoke``): run A trains steps 0-2 and
    saves at step 2 (format v2); then run B, the same command, resumes from
    step 2 and trains it alone. Check run A's losses against this
    configuration's earlier runs on the card (``CKPT_LOSSES``, four
    decimals: the codes and scales are bit-equal run to run), 4 launches of
    each B1 pass a step, the committed step, the manifest's version, its
    leaves and structure against the state's shapes and the shard file's
    exact size (the sum of the manifest's leaves: fp32 params, optimizer
    state, step, key); run B's loss bit-equal to run A's at step 2, 4
    launches of each B1 pass and none of B2/B3, every leaf of its final
    state equal to run A's by digest, and its peak device memory (restore
    included) no higher than run A's. Report the save's stall, the seconds
    to its COMMIT and the restore's seconds, with GB/s. Fails, with the
    space it found, when the disk cannot hold the checkpoint. Phase 6's
    full depth is not saved: its 12 GB moved through host files twice here
    and five times in phase 37;
11. drive the optimizers that have no kernel route through the CLI at full
    width, 3 steps of batch 8 x seq 128 each (phase 39's: the schedule spans
    the run, so two updates at a nonzero rate), with every launch count set
    to 0 just before each run: sm3, adafactor, factor4bit and shampoo4bit
    on the first of the 24 layers (phase 39's depth; shampoo4bit's first
    step decomposes every 128 x 128 Kronecker block, on the host's threads:
    ``transform.host_eigh``), each at the learning rate ``NEW_OPTIMIZERS``
    gives it and says why; check state bytes against the reference's
    counts, no kernel launched, losses finite and the last below the first;
    report step ms split into model and optimizer (CUDA events), peak
    memory, shampoo4bit's recompute step against a stale one, the host time
    of its inverse roots, and one batch decomposed alone by cuSOLVER's eigh
    and by ``host_eigh``;
12. card against CPU on the reduced config, three steps from the same
    weights: the five new optimizers and production4bit with ``--grad-comm``
    bf16, int8 and int4 (SR seed 0); losses within 3e-4 relative (shampoo32
    2e-3, shampoo4bit 5e-4: ``SMALL_NEW_RUNS``), a gap that the same model
    without its steps must exceed five times over; the agreement of 4-bit
    first-moment codes printed;
13. phase 6's command with ``--grad-comm int4``: wire bytes
    (1,003,596,800), 4 launches of each B1 pass per step, losses finite;
    step time and peak memory against phase 6's, and the step split into
    model, gradient wire format and optimizer;
14. hold both B1 passes against their plain versions at every fused leaf
    shape of qwen3-4b, chatglm3-6b and gemma2-2b at full depth (gemma2's
    wq/wk/wv as 29,952 slices of 8 or 4 rows, its post1/post2 as one slice
    of 13 rows; chatglm3's w2 of 1.57 G elements), RTN and SR, on random
    codes and stats: stats, codes and scales bit-equal, params within 1e-6
    relative (the plain versions run over runs of whole slices, which is
    exact); time both passes by event pairs against their bounds and sum
    each arch's step;
15. drive each of the three archs through ``repro_torch.launch.train`` at
    full width, production4bit with SR, ``ARCH_STEPS`` (3; 5 before phase
    40 took their time) steps of batch 8 x seq 128, with
    every launch count set to 0 just before and read just after: gemma2-2b
    at its 26 layers, qwen3-4b at ``QWEN3_LAYERS`` of 36 and chatglm3-6b at
    ``CHATGLM3_LAYERS`` of 28 (the unfused SR draw grows the peak ~1.6 and
    ~5.9 GB a layer); a 2-step probe at 12 and 4 layers before them gives the
    peak's growth a layer and the full depth's peak. Check state bytes (the
    reference's counts at that depth), 18 / 4 / 2 launches of each B1 pass a
    step and none of B2/B3, losses finite and the last below the first;
    report step ms (split into model and optimizer) and peak memory;
16. card against CPU on each arch's reduced config: 3 production4bit SR
    steps from the same weights, losses within 3e-4 relative and a gap the
    steps must open five times over, 4-bit m code agreement printed;
17. serve each arch at full depth with q4 weights through
    ``repro_torch.launch.serve``: phase 8's mix with 16 new tokens a
    request (``ARCH_SERVE_NEW_TOKENS``; phases 18, 23, 27 and 32 too), counts
    set to 0 just before and read just after; check weight bytes and q4 leaves (the reference's
    ``weight_report``), one B2 launch per q4 leaf, one B3 launch per q4 leaf
    and materialize, no B1, every stream complete; report prefill and
    decode ms, tok/s and peak memory;
18. gemma2-2b, one request alone (``--max-batch 1``, ``--s-max`` 8192): a
    prompt of 4,100 tokens and 16 new ones, so the windowed layers'
    4096-slot circular cache wraps. Its greedy tokens must equal a decode of
    the same weights with windowed caches, and where a decode with 8192
    slots in every layer (the window masking the older ones) picks another
    token, the engine's token must lie within twice the two decodes' logit
    difference of that decode's best: the two hold the same keys in another
    slot order, so only their roundings differ;
19. hold both B1 passes against their plain versions, RTN and SR, at the
    fused leaves of phi3.5-moe-42b-a6.6b and mixtral-8x7b at their training
    depths: the expert stacks (L, 16, 4096, 6400), (L, 16, 6400, 4096), (L,
    8, 4096, 14336), (L, 8, 14336, 4096) as L*E slices (the rank-1 lead
    stats over (L, E)) and ``wo``; time both passes against their bounds and
    sum each arch's step;
20. B2 and B3 on one whole q4 leaf of more than 2^32 elements (phi3.5's
    expert stack at its serving depth), bit-equal to their plain versions
    on windows at the start, around 2^31 and 2^32, and at the end; timed;
21. drive each MoE arch through ``repro_torch.launch.train`` at full width,
    cut in depth only (``PHI35_TRAIN_LAYERS``, ``MIXTRAL_TRAIN_LAYERS`` of 32),
    production4bit with SR, ``ARCH_STEPS`` steps of batch 8 x seq 128,
    counts set to 0 just before and read just after: state bytes (the reference's count at
    that depth), 4 launches of each B1 pass a step, none of B2/B3, ce and
    aux losses finite (aux positive), the total falling; step ms split into
    model and optimizer, peak memory;
22. card against CPU on each MoE arch's reduced config, 3 production4bit SR
    steps, losses within 3e-4 relative; the card's routing held to the
    CPU's: every expert choice that parts is shown at a near tie (two bf16
    ulps, or twice the call's largest card-CPU logit difference), counted,
    and the card then takes the CPU's choice;
23. serve each MoE arch with q4 weights at its serving depth
    (``PHI35_SERVE_LAYERS``, ``MIXTRAL_SERVE_LAYERS``) with phase 8's mix:
    weight bytes (the reference's count at that depth), 12 q4 leaves, one
    B2 launch each, B3 per leaf and materialize, every stream complete;
    tok/s, prefill and decode ms, peak memory.

24. hold both B1 passes against their plain versions, RTN and SR, at
    xlstm-125m's 11 fused leaves at full depth: ``w_in`` (3, 768, 1536) and
    ``w_out`` (3, 768, 768) of the three mLSTM subs, the sLSTM's ``w_gates``
    (3, 768, 4, 768) as 2,304 slices of 4 x 768, ``w_out`` and ``mlp/w1``-``w3``
    (3, 768, 1024) / (3, 1024, 768); time both passes against their bounds
    and sum the step;
25. drive xlstm-125m and hymba-1.5b through ``repro_torch.launch.train`` at
    full width, production4bit with SR, ``ARCH_STEPS`` steps of batch 8 x
    seq 128, counts set to 0 just before and read just after, at the depths of
    ``RECURRENT_TRAIN``: state bytes (the reference's counts), 11 / 0
    launches of each B1 pass a step (hymba has no last dim that is a
    multiple of 256: its 1.33 G 4-bit elements take the unfused SR draw),
    none of B2/B3, losses finite and falling; step ms split into model and
    optimizer, peak memory;
26. card against CPU on each recurrent arch's reduced config (GLA chunks of
    16, ssm_state 8), 3 production4bit SR steps from the same weights,
    losses within 3e-4 relative and a gap the steps open five times over;
27. hold B2 and B3 against their plain versions at every q4 leaf of each
    recurrent arch at full depth that has a kernel view, on the (R, C) view
    ``prepare_params`` gives them (9 views of xlstm's 26 such leaves, 19 of
    hymba's 59), inputs as phase 3's: codes, scales and values bit-equal;
    each view timed, summed over the tree. Then serve each with q4 weights
    at full depth through
    ``repro_torch.launch.serve`` on phase 8's mix: weight bytes and q4
    leaves (the reference's ``weight_report``), one B2 launch per q4 leaf
    with a kernel view (hymba's ``ssm_dt``, ``embed``, ``head`` and the
    15-layer unit's norms and scales have none and take the plain
    quantizer), B3 per such leaf and materialize, every stream complete;
    tok/s, prefill and decode ms, peak memory;
28. the reference's ``test_prefill_matches_decode_oracle_archs`` on the
    card, per recurrent arch: a batched, right-padded prefill of two
    prompts (``ORACLE_LENGTHS``: past one GLA chunk, and within one) and
    four decode steps after it, fed the same tokens, against a
    token-by-token decode whose finished row stops, every logit of both
    rows held: at the reduced config within the reference's 5e-2; at full
    width and depth with fp32 compute on both paths within 1e-3 (they then
    differ only in the order they sum in), and with bf16 compute within
    ``ORACLE_BF16_ATOL`` (the two paths' bf16 roundings part, more with
    depth);
29. hold both B1 passes against their plain versions, RTN and SR, at the
    fused leaves of whisper-large-v3 (encoder ``attn/wo``, decoder
    ``self/wo`` and ``cross/wo`` (32, 20, 64, 1280), ``mlp/w1`` (32, 1280,
    5120) and ``mlp/w2`` (32, 5120, 1280) of both stacks) and qwen2-vl-2b
    (``attn/wo`` (28, 12, 128, 1536), ``mlp/w1``/``w3`` (28, 1536, 8960),
    ``mlp/w2`` (28, 8960, 1536)) at full depth; time both passes against
    their bounds and sum each arch's step;
30. drive both through the library's training path (``build_train_step``;
    the CLIs refuse the modality-stub archs, as the reference's do) at full
    width and depth, production4bit with SR seed 0, 5 steps, counts set to
    0 just before and read just after: whisper at batch 2 of 1,500 frames
    (its 30-s encoder window, from a seeded torch generator) and 448 tokens,
    qwen2-vl at batch 4 x 1,024 with one image (64 text positions, a 16 x 16
    grid of patch embeddings with M-RoPE positions t = 64, h = 64 + row, w =
    64 + col, then text from 80 on); tokens and labels from the data
    pipeline. Check state bytes (the reference's counts), 7 / 4 launches of
    each B1 pass a step, none of B2/B3, losses finite and falling; report
    step ms split into model and optimizer, peak memory;
31. card against CPU on each one's reduced config (2 encoder layers, M-RoPE
    sections (4, 2, 2)), 3 production4bit SR steps from the same weights,
    losses within 3e-4 relative and a gap the steps open five times over;
32. hold B2 and B3 bit-equal to their plain versions at every q4 leaf view
    of both full trees (27 and 10 leaves, every one with a view: whisper's
    stacked LayerNorm scales and biases (32, 1280) among them), timed; then
    serve each with q4 weights at full size through the library: whisper
    encodes 4 x 1,500 frames once and decodes 16 greedy tokens of 4 rows
    over a 448-position cache (every step projects the cross K/V of all
    1,500 frames again, as the reference does); qwen2-vl prefills the 4 x
    1,024 image prompt and decodes 16 greedy steps over a 1,024-position
    cache. Check weight bytes (the reference's), one B2 launch per q4
    leaf, B3 per leaf and materialize, no B1, finite logits; report the
    encode / prefill ms, the decode step and peak memory;
33. the reference's decode parity checks on the card: teacher-forced
    logits against a token-by-token decode (whisper with ``enc_out``,
    qwen2-vl with embeds equal to the tokens' embedding rows), at the
    reduced configs within the reference's 2e-2, at full width and depth
    with fp32 compute within 1e-3 and with bf16 compute within
    ``STUB_BF16_ATOL``;
34. B1 on tiles, in one process: internlm2-1.8b's ``wo``, ``w1``, ``w2`` and
    ``w3`` at full size, cut into the tiles of the (2, 1), (1, 2) and (2, 2)
    plans (``sharding.rules.wire_spec``, the parameters' ZeRO layout); both
    passes per tile with the tile's offsets, the stats max-merged across the
    tiles here; params, codes, scales and stats bit-equal to one whole-leaf
    launch of each pass, RTN and SR; the tiles' SR launches timed against
    the whole leaf's (event pairs, median of 21);
35. the mesh train step: internlm2-1.8b at full width and depth,
    production4bit with SR, as two processes on ``cuda:0`` over gloo (NCCL
    refuses two ranks on one card; gloo moves CUDA tensors through host
    memory), mesh (data=2, model=1). Fed one seeded gradient tree, the
    update's params and state bit-equal to the one-process update on the
    card; then 2 steps of the smoke's batch with every launch count set to 0
    just before and read just after: losses within 1e-4 relative of phase
    6's, each rank's state bytes equal to its plan's to the byte, 4
    launches of each B1 pass a step on each rank's tiles and none of B2/B3;
    each step's time split into compute, collective and update, and each
    rank's peak;
36. ``quantized_all_reduce`` (int4, SR) in the same two ranks on one layer's
    leaves of internlm2-1.8b (and a norm): each rank's result bit-equal to
    the host oracle of ``tests/test_comms.py`` computed on the card, the
    two ranks' bits equal; timed.
37. save and resume on the mesh, through the train CLI: internlm2-1.8b at
    full width and 2 of its 24 layers (``MESH_CKPT_LAYERS``, phase 10's
    configuration), production4bit with SR seed 0, batch 8 x seq 128,
    every run ``--steps 3 --ckpt-every 2`` (one learning-rate schedule) into
    ``build/ckpt_mesh_smoke`` (free space checked, ``--keep-last 1``). Run
    A, fresh on ``--mesh 2x1`` (two processes on ``cuda:0`` over gloo, as in
    phase 35), trains steps 0-2 and saves at step 2: the step dir holds
    ``num_hosts`` 2 and COMMIT, the two host files sum to the bytes of the
    state's leaves, the manifest's leaves and structure are a one-process
    save's (phase 10's, and one from the state's shapes), 4 launches of
    each B1 pass a step on each rank, its losses within 1e-4 of phase 10's.
    Run B, the same command, resumes from step 2 on ``2x1``: its step-2
    loss bit-equal to A's, each rank's final state equal to A's leaf for
    leaf (sha256 digests from ``--digests``), each rank's peak at most A's.
    Run C resumes the same save on ``--mesh 1x2``, run D in one process:
    their step-2 losses within 1e-4 relative of A's, D's peak at most phase
    10's fresh run's (C's is printed beside A's: a 1x2 rank computes all 8
    rows, so its training peak is its own layout's, and a fresh 1x2 run is
    not part of the phase). Prints every run's save stall, seconds to
    COMMIT, restore seconds a rank, step ms and peaks.
38. the roofline on the card: (a) ``launch.dryrun.run_all`` over
    internlm2-1.8b's four shapes on both production plans, on the ``meta``
    device: no cell in error (the counts of ok, skipped and refused printed;
    the records in ``chiprun_out/dryrun.json``); (b) the roofline of
    phase 6's step (internlm2-1.8b, 8 x 128, production4bit with SR, one
    rank) with the constants of the card ``nvidia-smi`` names (a card
    other than the H100 SXM fails the phase): the compute term (bf16
    products at the tensor cores' rate, the fp32 attention at the fp32
    rate), memory and collective terms, the bottleneck, ``model_flops``,
    and both shares of phase 6's median step (the bound over the step,
    ``model_flops`` over step x bf16 peak); (c) one real production4bit+SR
    step of the full model on the card under the same counters: matmul
    FLOPs equal to (b)'s, type by type, bytes (B1's byte model at its 4 + 4
    launches included) within 2% of (b)'s;
    not a path run, so its launches are not in the kernel table; (d) phase
    35's collective bytes, reckoned from the plan with no world
    (``MeshStep.reckon``), equal to the bytes each of its steps recorded,
    and likewise phase 40's (1, 2) cell.
39. the rules that need whole-leaf statistics on the mesh, in phase 35's
    two processes after phase 40 (through ``build_train_step(mesh=)`` as the
    train CLI's ``--mesh 2x1`` runs it: its learning-rate schedule, data and
    seeds; slice 14 ran it through the CLI, seven two-rank starts and stops
    with phase 37): internlm2-1.8b at full width on phase 11's depth (1 of
    the 24 layers), phase 11's learning rates and steps, batch 8 x seq 128,
    for sm3, adafactor, factor4bit and shampoo4bit: each rank's state bytes
    equal to its plan's (``MESH_OPTIM_RANK_BYTES``, predicted from the plan
    on ``meta``), all three losses equal on both ranks and within 1e-4
    relative of phase 11's (the third after the second update, Shampoo's on
    its stale roots), no launch on either rank (none of these rules has a
    kernel route); prints each step's split into compute, collective and
    update, and each rank's eigh matrices and seconds on Shampoo's
    recompute step.
40. the mesh step computing tensor-parallel on the model axis, in phase
    35's two processes after phase 36: internlm2-1.8b at full width and
    depth on a (data=1, model=2) mesh, production4bit with SR, 2 steps of
    batch 8 x seq 128: each rank computes its 8 of the 16 heads, its 4096
    of the 8192 mlp columns and its half of the vocabulary, and sums the
    partials over the pair (``sharding.tensor_parallel``); both ranks'
    losses bit-equal and within 1e-4 relative of phase 6's, each rank's
    state bytes equal to its plan's, 4 launches of each B1 pass a step on
    each rank and none of B2/B3, the collective bytes each step recorded
    equal to ``MeshStep.reckon``'s (reckoned on ``meta``, and again in
    phase 38 (d)); prints each step's split into compute, collective and
    update, each rank's peak, the reckoning before this slice
    (11,334,660,216 B a step a rank) beside the new one, and the fp32 and
    bf16 row-parallel partial products of ``wo`` and ``w2`` timed on the
    card.
41. the recompute (``models.remat``): (a) internlm2-1.8b at full width and
    4 of its 24 layers, batch 8 x seq 128, through the library on the card:
    the loss and every parameter's gradient with ``remat`` on bit-equal to
    off (a gradient that an op's CUDA backward parts is named and held
    within the gap two remat-off runs open), and each one's
    forward+backward peak and ms; (b) the blockwise training attention at
    internlm2-1.8b's train_4k layout (1, 4096, 16 / 8 heads, 128) in fp32,
    causal, then with a window of 1024 and a softcap of 50: output and
    q/k/v gradients within 1e-5 of the largest magnitude of a float64
    whole-score softmax's, its forward+backward ms (CUDA events) and peak
    beside an fp32 whole-score softmax's.
42. MoE layers on the mesh as the reference's rules cut them (slice 17),
    in phase 35's two processes after phase 40: phi3.5-moe at full width
    (d 4096, 16 experts, d_ff 6400, vocab 32064) and 2 of its 32 layers,
    production4bit with SR, 2 steps of batch 8 x seq 128, on (data=2,
    model=1) (one group of 1024 tokens split over the two data shards: the
    routing's counts gathered over the data group) and on (1, 2) (8 of the
    16 experts a rank, their outputs gathered over the pair); the oracle is
    the same run in one process on the card, made before the ranks start
    and freed. Each rank's state bytes equal to its plan's, the collective
    bytes each step recorded equal to ``MeshStep.reckon``'s (on ``meta``),
    the logged losses equal on both ranks and within 1e-4 relative of the
    oracle's, each B1 pass launched as often as in the oracle (every fused
    leaf, on the rank's tiles) and no B2/B3; each rank takes the oracle's
    expert choice wherever its own parts from it at a near tie (phase 22's
    rule; any other parting fails; the partings are counted), and at (2, 1)
    its shard's slots equal the oracle's; each rank's largest |logit|
    difference from the oracle in any call and its share of parted
    assignments printed and held under ``MOE_MESH_DLOGIT`` and
    ``MOE_MESH_PARTED`` (the drift a wrong input to the router would show);
    B1 on the (1, 2) tiles of the
    ``moe/w1`` stack bit-equal to the whole leaf's launch (phase 34's check) and timed.
    Prints each step's split into compute, collective and update, each
    rank's gathered layer and peak, and the launches.
    ``python3 chip_smoke.py --moe-mesh-phase`` runs the build and this phase
    alone.
43. the recurrent blocks on the mesh as the reference's rules cut them
    (slice 18), with the ``embed``-cut fallbacks (slice 19), in phase 35's
    two processes after phase 42, (data=1, model=2), production4bit with
    SR, 2 steps of batch 8 x seq 128: xlstm-125m whole (its mLSTM and sLSTM
    on 2 of the 4 heads a rank) and hymba-1.5b at full width and 4 of its
    32 layers (its SSM on 8 of the 16 states a rank, ``ssm_dt``
    row-parallel; its attention row-parallel: 25 heads, ``wq`` cut on its
    800 of 1600 rows a rank; its vocabulary of 32,001 cut on the width: the
    lookup column-parallel, the cross entropy row-parallel); the oracle is
    the same run in one process on the card, made before the ranks start
    and freed. The logged losses equal on both ranks and within 1e-4
    relative of the oracle's, each rank's state bytes equal to its plan's,
    the collective bytes each step recorded equal to ``MeshStep.reckon``'s
    (on ``meta``) and to the prediction (``RECURRENT_MESH_RECKONED``), each
    B1 pass launched as often as in the oracle (on the rank's tiles) and no
    B2/B3, the largest layer and the top-level leaves a rank gathers equal
    to the prediction (``RECURRENT_MESH_GATHERED``,
    ``RECURRENT_MESH_TOP``), and for hymba-1.5b each rank's calls of the
    three ``embed``-cut modes (``tensor_parallel.CALLS``) above zero.
    Prints each step's split into compute, collective and update, each
    rank's peak, and the gathered layer and collective bytes before the
    recurrent split and before the fallbacks.
    ``python3 chip_smoke.py --recurrent-mesh-phase`` runs the build and this
    phase alone.

Every training phase runs with the configs' ``remat=True`` (the reference's
default): each layer is recomputed in the backward, and on the mesh (phases
35, 37, 39, 40, 42, 43) gathered again for it.

Each phase's seconds are printed as it ends (``phase clock:``) and kept in
``chiprun_out/chip_smoke.json``.

The kernel table's launch counts sum the path runs (phases 6, 15, 21, 25,
30, 35, 37, 40, 42 and 43 (their one-process oracles and the layouts) for B1; 8,
17, 23, 27 and 32 for B2/B3), each counted from 0
just before it (a spawned rank's counts start at 0 with its process); phase
39's runs count none.

Prints the kernel table as a JSON line, then the device line as the last
line. ``python3 chip_smoke.py --mesh-phases`` builds the kernels and runs
phases 10, 34-37, 40, 42 and 43 alone (no result lines);
``--mesh-optim-phases`` runs phases 11 and 39 alone; ``--recompute-phases``
runs phases 41 and 6 alone; ``--moe-mesh-phase`` runs phase 42 alone,
``--recurrent-mesh-phase`` phase 43. Needs a CUDA card and the
repository beside it; without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's memory rate and fp32 rate outside the tensor cores: main sets
# them from repro_torch.roofline.analysis.H100 (the one place the H100's
# constants are written)
HBM_BYTES_PER_S = None
FP32_FLOPS_PER_S = None
INT_ALU_LANES_PER_SM = 64      # Hopper SM: 32-bit shift, funnel shift and logic ops per clock
# Stochastic rounding draws word 0 of two Threefry-2x32-20 blocks per element
# (m on stream 0, v on stream 1): 20 rounds of add, rotate, xor, of which the
# last rotate and xor are dead, and stream 0's first rotate (of key word 1)
# is the same for a whole slice. That leaves 75 rotates and xors on the
# integer ALU pipe per element (the adds may go to the IMAD pipe); phase 1
# checks the count against the SASS.
SR_ALU_OPS_PER_ELEMENT = 2 * (19 + 19) - 1
# The 5-step losses of the full-size run (chip runs of the two earlier
# versions of B1, which gave the same codes and scales).
EXPECTED_LOSSES = (11.8285, 11.6147, 11.5683, 11.3304, 11.3129)
STATE_BYTES_INTERNLM2 = 4_590_578_552
STEPS = 5
# phases 15, 21 and 25: steps of each arch's CLI run (5 before slice 15, which
# cut them to 3 to make room for phase 40: every check holds at 3; the last
# two steps of the seven runs took ~25 s on an H100 80GB HBM3 at 700 W)
ARCH_STEPS = 3
TRAIN_ARGS = ["--arch", "internlm2-1.8b", "--optimizer", "production4bit", "--sr-seed", "0",
              "--steps", str(STEPS), "--batch", "8", "--seq", "128", "--device", "cuda"]
# the fused leaves of internlm2-1.8b: (names, shape, leaves of that shape)
LEAF_SHAPES = (("wo", (24, 16, 128, 2048), 1), ("w1,w3", (24, 2048, 8192), 2),
               ("w2", (24, 8192, 2048), 1))
SMALL_RTOL = 3e-4
OUT_DIR = ROOT / "chiprun_out"
# the q4 serving leaves of internlm2-1.8b: (names, shape, leaves of that shape)
Q4_LEAVES = (("wq", (24, 2048, 16, 128), 1), ("wk,wv", (24, 2048, 8, 128), 2),
             ("wo", (24, 16, 128, 2048), 1), ("w1,w3", (24, 2048, 8192), 2),
             ("w2", (24, 8192, 2048), 1), ("norm1,norm2", (24, 2048), 2),
             ("embed", (92544, 2048), 1), ("head", (2048, 92544), 1))
Q4_BYTES_PER_ELEMENT = 4 + 0.5 + 4 / 128  # fp32 one way, codes + scales the other
WARP_ISSUE_PER_SM = 4  # Hopper SM: four sub-partitions, one warp instruction a clock each
Q4_ELEMENTS_PER_STEP = 8  # B2: elements a lane quantizes between two warp votes
Q4_LEAF_COUNT = sum(count for _, _, count in Q4_LEAVES)  # 11
WEIGHT_BYTES_Q4 = 1_003_596_800
VOCAB = 92544
SERVE_ATOL = 2e-2
SERVE_REQUESTS, SERVE_NEW_TOKENS, SERVE_DRAIN = 8, 64, 8
# the other archs' serving phases (17, 18, 23, 27 and 32) decode two drains
# of new tokens a request: 64 before phase 42 came, which the smoke's clock
# could not hold beside it (the decode steps are host-held, 32-212 ms each)
ARCH_SERVE_NEW_TOKENS = 16
# phase 11: the optimizers without a kernel route at full width, 3 steps,
# with their learning rates. At the CLI's 1e-3 the loss of adafactor (11.83
# -> 12.94 on an H100 80GB HBM3 at 700 W) and of factor4bit rose over the 4
# steps: full-strength steps on every leaf of a random 24-layer model, so
# they take 1e-4. shampoo4bit's steps at 1e-3 did not move the model past
# the batches' own spread: its zero-excluding 4-bit v starts at 1/16 of its
# scale, far above the squared gradients, and the graft gives the Shampoo
# direction that damped AdamW step's norm; it takes 1e-1
NEW_OPTIMIZERS = (("sm3", 1e-3), ("adafactor", 1e-4), ("factor4bit", 1e-4),
                  ("shampoo4bit", 1e-1))
# phases 11 and 39 take the same steps: the schedule spans --steps, so
# their updates run at the same rates only then
NEW_STEPS = 3
NEW_ARGS = ["--arch", "internlm2-1.8b", "--steps", str(NEW_STEPS), "--batch", "8", "--seq",
            "128", "--device", "cuda"]
# shampoo4bit's first step decomposes every 128 x 128 Kronecker block: 54,016
# matrices at 1 layer, ~54 s as one cuSOLVER call each on an H100 80GB HBM3
# at 700 W (the port now takes them on the host's threads; phase 11 still
# times cuSOLVER's eigh alone). Embed and head alone are 46,272 of them at
# any depth, and the full 24 layers ~230,000, so its run keeps 1 of the 24
# layers; the other three take the same depth, phase 39's
# (their full-depth runs gave the smoke's clock to phase 39; the full-depth
# state bytes, 7,557,380,132 / 7,645,301,960 / 1,092,458,700, are held to
# the reference's in tests/test_torch_optim.py)
SHAMPOO_LAYERS = 1
# the reference's eval_shape counts at 1 layer (shampoo4bit:
# tests/test_torch_optimizers.py; the others from the same count)
NEW_STATE_BYTES = {"sm3": 1_768_862_952, "adafactor": 1_772_375_056,
                   "factor4bit": 239_275_020, "shampoo4bit": 1_400_141_288}
EIGH_PROBE = 1024
# phase 12: (optimizer, lr, grad-comm, SR seed, loss tolerance card vs CPU).
# shampoo4bit's 4-bit zero-excluding v damps its first steps, so it needs lr
# 0.1 to move the loss past five times the tolerance; lr 0.1 makes shampoo32
# and factor4bit diverge, so the others take 3e-2. shampoo32's full-size
# steps carry the bf16 and eigh differences furthest: 7.46e-4 measured on
# an H100 80GB HBM3 at 700 W, held to 2e-3
SMALL_NEW_RUNS = (("sm3", 3e-2, "fp32", None, SMALL_RTOL),
                  ("adafactor", 3e-2, "fp32", None, SMALL_RTOL),
                  ("factor4bit", 3e-2, "fp32", None, SMALL_RTOL),
                  ("shampoo32", 3e-2, "fp32", None, 2e-3),
                  ("shampoo4bit", 1e-1, "fp32", None, 5e-4),
                  ("production4bit", 1e-3, "bf16", 0, SMALL_RTOL),
                  ("production4bit", 1e-3, "int8", 0, SMALL_RTOL),
                  ("production4bit", 1e-3, "int4", 0, SMALL_RTOL))
# phase 13: int4 gradient wire bytes of internlm2-1.8b (the reference's)
WIRE_BYTES_INT4 = 1_003_596_800
# phases 14-18 (slice 7): qwen3-4b, chatglm3-6b, gemma2-2b. Phase 14: every
# fused leaf shape of the three archs at full depth: (arch, names, shape,
# leaves of that shape a step). gemma2's head_dim 256 makes wq/wk/wv fused,
# as 29,952 slices of 8 or 4 rows; its sandwich-norm scales post1/post2 are
# one slice of 13 rows (the reference's fp32 regexes do not match them)
ARCH_LEAF_SHAPES = (
    ("gemma2-2b", "wq", (13, 2304, 8, 256), 2),
    ("gemma2-2b", "wk,wv", (13, 2304, 4, 256), 4),
    ("gemma2-2b", "wo", (13, 8, 256, 2304), 2),
    ("gemma2-2b", "w1,w3", (13, 2304, 9216), 4),
    ("gemma2-2b", "w2", (13, 9216, 2304), 2),
    ("gemma2-2b", "post1,post2", (13, 2304), 4),
    ("qwen3-4b", "wo", (36, 32, 128, 2560), 1),
    ("qwen3-4b", "w1,w3", (36, 2560, 9728), 2),
    ("qwen3-4b", "w2", (36, 9728, 2560), 1),
    ("chatglm3-6b", "wo", (28, 32, 128, 4096), 1),
    ("chatglm3-6b", "w2", (28, 13696, 4096), 1),
)
ARCH_PLAIN_CHUNK = 1 << 26  # elements of a leaf the plain versions take at a time
# phase 15: arch -> (layers, layers trained, B1 leaves a step, state bytes at
# that depth: the reference's eval_shape counts, tests/test_torch_archs_optim.py,
# layers of a 2-step probe run or None). The probe and the run give the
# peak's growth a layer (linear there: the unfused SR draw of wq/wk/wv, and
# chatglm3-6b's w1/w3, grows with the depth) and so the depth that fits. The
# draw's int64 temporaries also fragment the allocator by 11-14 GB, so the
# deepest depths that fit are found by running them: scripts_train_depth.py
# on an H100 80GB HBM3 at 700 W (PERF.md section 4) ran qwen3-4b at 28
# layers (80.8 of the card's 85.0 GB reserved) and not 30, chatglm3-6b at 9
# (82.3 GB reserved) and not 10
QWEN3_LAYERS, CHATGLM3_LAYERS = 28, 9
ARCH_TRAIN = {
    "gemma2-2b": (26, 26, 18, 6_807_623_456, None),
    "qwen3-4b": (36, QWEN3_LAYERS, 4, 9_138_936_936, 12),
    "chatglm3-6b": (28, CHATGLM3_LAYERS, 2, 6_155_209_764, 4),
}
# phase 17: arch -> (q4 weight bytes, q4 leaves, layers: None for full
# depth, q4 leaves with a kernel view): the reference's weight_report; B2/B3
# take the leaves with a kernel view, the plain quantizer the others
ARCH_SERVE = {
    "qwen3-4b": (2_343_578_016, 13, None, 13),
    "chatglm3-6b": (3_316_849_664, 11, None, 11),
    "gemma2-2b": (1_388_877_120, 23, None, 23),
}
# phase 18: one gemma2-2b request that wraps the windowed layers' cache
LONG_PROMPT, LONG_S_MAX = 4100, 8192
# phases 19-23 (slice 8): phi3.5-moe-42b-a6.6b and mixtral-8x7b, cut in depth
# only (neither fits one card whole). Training depths: the deepest that
# scripts_train_depth.py ran on an H100 80GB HBM3 at 700 W (PERF.md section
# 4: phi3.5 at 5 layers peaked at 80.2 GB, mixtral at 4 at 72.3 GB, both with
# expandable segments; with the default allocator mixtral at 4 ran out with
# 24.5 GiB reserved but unallocated); serving depths likewise with --serve
# (q4: materialize holds the whole tree in fp32 for the length of a call;
# 79.5 and 82.0 GB)
PHI35, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x7b"
PHI35_TRAIN_LAYERS, MIXTRAL_TRAIN_LAYERS = 5, 4
PHI35_SERVE_LAYERS, MIXTRAL_SERVE_LAYERS = 13, 12
# phase 19: B1 at the expert shapes (and wo) at the training depths
MOE_LEAF_SHAPES = (
    (PHI35, "wo", (PHI35_TRAIN_LAYERS, 32, 128, 4096), 1),
    (PHI35, "moe/w1,w3", (PHI35_TRAIN_LAYERS, 16, 4096, 6400), 2),
    (PHI35, "moe/w2", (PHI35_TRAIN_LAYERS, 16, 6400, 4096), 1),
    (MIXTRAL, "wo", (MIXTRAL_TRAIN_LAYERS, 32, 128, 4096), 1),
    (MIXTRAL, "moe/w1,w3", (MIXTRAL_TRAIN_LAYERS, 8, 4096, 14336), 2),
    (MIXTRAL, "moe/w2", (MIXTRAL_TRAIN_LAYERS, 8, 14336, 4096), 1),
)
# phase 20: one q4 leaf of more than 2^32 elements: phi3.5's expert stack at
# its serving depth, as B2/B3 meet it there (the kernels' (R, C) view)
BIG_Q4_SHAPE = (PHI35_SERVE_LAYERS, 16, 4096, 6400)
BIG_Q4_WINDOW = 1 << 26  # elements of each window held against the plain versions
# phase 21: as ARCH_TRAIN; state bytes: the reference's eval_shape counts at
# that depth (tests/test_torch_moe_optim.py)
MOE_STATE_BYTES = {(PHI35, 4): 7_465_588_440, (PHI35, 5): 8_806_588_152,
                   (PHI35, 6): 10_147_587_864, (MIXTRAL, 3): 6_587_528_760,
                   (MIXTRAL, 4): 8_084_208_216, (MIXTRAL, 5): 9_580_887_672}
MOE_TRAIN = {
    PHI35: (32, PHI35_TRAIN_LAYERS, 4, MOE_STATE_BYTES[PHI35, PHI35_TRAIN_LAYERS], None),
    MIXTRAL: (32, MIXTRAL_TRAIN_LAYERS, 4, MOE_STATE_BYTES[MIXTRAL, MIXTRAL_TRAIN_LAYERS], None),
}
# phase 23: as ARCH_SERVE; q4 bytes: the reference's weight_report at that depth
MOE_Q4_BYTES = {(PHI35, 11): 7_738_233_600, (PHI35, 12): 8_429_022_208,
                (PHI35, 13): 9_119_810_816, (MIXTRAL, 10): 7_849_153_024,
                (MIXTRAL, 11): 8_620_140_288, (MIXTRAL, 12): 9_391_127_552}
MOE_SERVE = {
    PHI35: (MOE_Q4_BYTES[PHI35, PHI35_SERVE_LAYERS], 12, PHI35_SERVE_LAYERS, 12),
    MIXTRAL: (MOE_Q4_BYTES[MIXTRAL, MIXTRAL_SERVE_LAYERS], 12, MIXTRAL_SERVE_LAYERS, 12),
}
# phases 24-28 (slice 9): xlstm-125m (one scan unit of period 4: three mLSTM
# subs and an sLSTM sub, 3 layers each) and hymba-1.5b (attention + SSM heads,
# five scan units of runs). Phase 24: xlstm's fused leaves at full depth
XLSTM, HYMBA = "xlstm-125m", "hymba-1.5b"
XLSTM_LEAF_SHAPES = (
    (XLSTM, "mlstm w_in", (3, 768, 1536), 3),
    (XLSTM, "w_out", (3, 768, 768), 4),
    (XLSTM, "slstm w_gates", (3, 768, 4, 768), 1),
    (XLSTM, "slstm mlp/w1,w3", (3, 768, 1024), 2),
    (XLSTM, "slstm mlp/w2", (3, 1024, 768), 1),
)
# phase 25: as ARCH_TRAIN; state bytes: the reference's eval_shape counts
# (tests/test_torch_recurrent_train.py)
RECURRENT_TRAIN = {
    XLSTM: (12, 12, 11, 669_510_744, None),
    HYMBA: (32, 32, 0, 2_192_732_204, None),
}
# phase 27: as ARCH_SERVE
RECURRENT_SERVE = {
    XLSTM: (67_447_776, 26, None, 26),
    HYMBA: (761_193_920, 70, None, 59),
}
# phase 28: the two prompts' lengths (the full configs' GLA chunk is 128),
# the cache slots, and the reference's tolerance; at full width and depth,
# the bounds with fp32 and with bf16 compute (PERF.md section 2)
ORACLE_LENGTHS, ORACLE_S_MAX, ORACLE_ATOL = (150, 41), 256, 5e-2
ORACLE_FP32_ATOL = 1e-3
ORACLE_BF16_ATOL = {XLSTM: 0.1, HYMBA: 0.5}
# phases 29-33 (slice 10): whisper-large-v3 (encoder-decoder: 32 + 32 layers,
# LayerNorm, sinusoidal positions, cross-attention) and qwen2-vl-2b (embeds
# input, M-RoPE), through the library entry points (the CLIs refuse them, as
# the reference's do). Phase 29: their fused leaves at full depth
WHISPER, QWEN2VL = "whisper-large-v3", "qwen2-vl-2b"
STUB_LEAF_SHAPES = (
    (WHISPER, "attn/wo, self/wo, cross/wo", (32, 20, 64, 1280), 3),
    (WHISPER, "mlp/w1", (32, 1280, 5120), 2),
    (WHISPER, "mlp/w2", (32, 5120, 1280), 2),
    (QWEN2VL, "attn/wo", (28, 12, 128, 1536), 1),
    (QWEN2VL, "mlp/w1,w3", (28, 1536, 8960), 2),
    (QWEN2VL, "mlp/w2", (28, 8960, 1536), 1),
)
# whisper's 30-s encoder window and its decoder's positions; qwen2-vl's
# prompt: VL_TEXT text tokens, one 448 x 448 image as a VL_GRID x VL_GRID
# grid of merged patches, then text
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
VL_SEQ, VL_TEXT, VL_GRID = 1024, 64, (16, 16)
# phase 30: arch -> (B1 leaves a step, state bytes: the reference's
# eval_shape count (tests/test_torch_stub_optim.py), batch, decoder length)
STUB_TRAIN = {
    WHISPER: (7, 2_048_477_144, 2, WHISPER_TOKENS),
    QWEN2VL: (4, 3_218_982_808, 4, VL_SEQ),
}
# phase 32: as RECURRENT_SERVE (the reference's weight_report); 4 rows
STUB_SERVE = {
    WHISPER: (815_385_360, 27, None, 27),
    QWEN2VL: (820_073_088, 10, None, 10),
}
STUB_ROWS = 4
# phase 33: rows and tokens of the teacher-forced check, the reference's
# tolerance (test_encdec_decode_parity, test_archs_smoke) at the reduced
# configs, and the full-size bounds with bf16 compute: about twice the
# readings of the first chip run on an H100 80GB HBM3 at 700 W (0.057 and
# 0.090; fp32 compute read 6.2e-6 and 1.25e-5; PERF.md section 2)
STUB_ORACLE_ROWS, STUB_ORACLE_TOKENS, STUB_ORACLE_ATOL = 2, 16, 2e-2
STUB_BF16_ATOL = {WHISPER: 0.12, QWEN2VL: 0.18}
# phases 34-36 (slice 11): internlm2-1.8b's fused leaves with their axes, the
# plans B1 is held on tile by tile, the mesh of the two-process run and its
# steps, and the leaves of the all-reduce check (one layer's, and a norm)
MESH_LEAVES = (("wo", (24, 16, 128, 2048), ("layers", "heads", "head_dim", "embed")),
               ("w1", (24, 2048, 8192), ("layers", "embed", "mlp")),
               ("w2", (24, 8192, 2048), ("layers", "mlp", "embed")),
               ("w3", (24, 2048, 8192), ("layers", "embed", "mlp")))
TILE_MESHES = ((2, 1), (1, 2), (2, 2))
MESH_SHAPE, MESH_STEPS = (2, 1), 2
ALL_REDUCE_LEAVES = (("wq", (2048, 16, 128)), ("wo", (16, 128, 2048)), ("w1", (2048, 8192)),
                     ("w2", (8192, 2048)), ("norm1", (2048,)))
# phase 40 (slice 15): the tensor-parallel mesh, its steps, and the collective
# bytes a step a rank that MeshStep.reckon gave this (1, 2) cell before the
# compute was split (every fp32 layer gathered over the model axis)
TP_SHAPE, TP_STEPS = (1, 2), 2
TP_RECKON_BEFORE = 11_334_660_216
# phase 42 (slice 17): phi3.5-moe at full width and MOE_MESH_LAYERS of its 32
# layers on the mesh, in phase 35's two processes: one group of 1024 tokens
# split over the data shards at (2, 1), 8 of the 16 experts a rank at (1, 2);
# the one-process run of the same steps and batches as the oracle; the expert
# stack B1 is held on tile by tile under the (1, 2) plan (phase 34's check)
MOE_MESH_ARCH, MOE_MESH_LAYERS, MOE_MESH_STEPS = "phi3.5-moe-42b-a6.6b", 2, 2
MOE_MESH_LAYOUTS = ((2, 1), (1, 2))
MOE_MESH_BATCH, MOE_MESH_SEQ = 8, 128
MOE_MESH_RTOL = 1e-4
# the routing's drift from the one-process run a rank may show, each about
# twice its layout's reading on an H100 (PERF.md): its largest |logit|
# difference in any call (read 0.07812 / 0.15625) and the share of its
# assignments that part at near ties (0.977% / 1.831%)
MOE_MESH_DLOGIT = {(2, 1): 0.16, (1, 2): 0.32}
MOE_MESH_PARTED = {(2, 1): 0.02, (1, 2): 0.04}
MOE_TILE_LEAVES = (("moe/w1", (MOE_MESH_LAYERS, 16, 4096, 6400),
                    ("layers", "experts", "embed", "mlp")),)
# phase 43 (slice 18): the recurrent blocks on the mesh as the rules cut
# them, in phase 35's two processes after phase 42: (arch, layers kept or
# None for whole), each on (1, 2): xlstm-125m's mLSTM and sLSTM on 2 of the 4
# heads a rank, hymba-1.5b's SSM on 8 of its 16 states a rank (ssm_dt on its
# rows); the one-process run of the same steps and batches as the oracle
RECURRENT_MESH = (("xlstm-125m", None), ("hymba-1.5b", 4))
RECURRENT_MESH_LAYOUT, RECURRENT_MESH_STEPS = (1, 2), 2
RECURRENT_MESH_BATCH, RECURRENT_MESH_SEQ = 8, 128
RECURRENT_MESH_RTOL = 1e-4
# the largest layer a rank gathers (fp32) and one step's collective bytes a
# rank (MeshStep.reckon on meta, PERF.md section 6), and both before the
# recurrent leaves split (every one gathered whole over the model axis) and
# before the embed-cut fallbacks split (hymba's attention, embed and head
# gathered whole); the top-level leaves a rank gathers (fp32)
RECURRENT_MESH_GATHERED = {"xlstm-125m": 11_802_624, "hymba-1.5b": 83_152_300}
RECURRENT_MESH_RECKONED = {"xlstm-125m": 610_551_232, "hymba-1.5b": 1_781_304_976}
RECURRENT_MESH_BEFORE = {"xlstm-125m": (18_880_512, 647_563_264),
                         "hymba-1.5b": (113_440_300, 1_562_871_952)}
RECURRENT_MESH_FALLBACK_BEFORE = {"hymba-1.5b": (95_440_300, 1_644_331_152)}
RECURRENT_MESH_TOP = {"xlstm-125m": 154_536_960, "hymba-1.5b": 204_812_800}
# the embed-cut modes each rank must run (tensor_parallel.CALLS)
RECURRENT_MESH_MODES = {"hymba-1.5b": ("row_parallel_attention", "column_parallel_lookup",
                                       "row_parallel_cross_entropy")}
# the parts of the mesh phases that run in phase 35's two processes, in
# order: phases 35, 36, 40, 39, 42 and 43
MESH_PARTS = ("train", "all_reduce", "tp", "optim", "moe", "recurrent")
# phases 10 and 37 (slices 5 and 12): the checkpoint runs, all with the same
# --steps (the CLI's schedule spans them) and the step saved, at 2 of the 24
# layers: an even depth, so the stacked leaves' layer dim splits over data=2
# as at full depth. At full depth their 12 GB saves and restores through
# host files took 97 s (phase 10) and 159-196 s (phase 37) of the smoke's
# clock on an H100 80GB HBM3 at 700 W. Run A's losses at this depth, as the
# card gave them there (to six decimals; held to four)
MESH_CKPT_LAYERS = 2
CKPT_LOSSES = (11.700937, 11.104362, 11.074847)
MESH_CKPT_ARGS = ["--arch", "internlm2-1.8b", "--optimizer", "production4bit", "--sr-seed", "0",
                  "--steps", "3", "--batch", "8", "--seq", "128", "--device", "cuda",
                  "--layers", str(MESH_CKPT_LAYERS), "--ckpt-every", "2", "--keep-last", "1"]
MESH_CKPT_STEP = 2
# phase 38 (slice 13): the dry run's cells (internlm2-1.8b's four shapes on
# both production plans: the single-pod sweep of every arch took about 100 s
# on an H100 machine's host, over the phase's budget; the whole 80-cell sweep
# is run by hand, PERF.md section 6), the roofline of phase 6's step on one
# rank, and the 2% bar on its bytes against the counted real step
DRYRUN_ARCHS = ("internlm2-1.8b",)
ROOFLINE_ARGS = ("internlm2-1.8b", 8, 128, "production4bit")
ROOFLINE_BYTES_RTOL = 0.02
# phase 39 (slice 14): the rules that need whole-leaf statistics on the mesh
# at phase 11's depth; each rank's state bytes under the (data=2, model=1)
# plan at 1 layer (sharding.specs.plan_nbytes on meta, PERF.md section 6)
MESH_OPTIM_RANK_BYTES = {"sm3": 884_913_384, "adafactor": 888_425_488,
                         "factor4bit": 122_072_076, "shampoo4bit": 701_165_416}


# each phase's seconds, as main's laps record them
# phase 41: internlm2-1.8b at full width and RECOMPUTE_LAYERS of its 24
# layers, batch 8 x 128, remat on against off; the training attention at
# internlm2-1.8b's train_4k head layout (B, S, heads, kv heads, head dim),
# causal, then with a window and a softcap, against a float64 whole-score
# softmax
RECOMPUTE_LAYERS = 4
RECOMPUTE_ATTN = ((1, 4096, 16, 8, 128, 0, 0.0), (1, 4096, 16, 8, 128, 1024, 50.0))
ATTN_REL = 1e-5
PHASE_SECONDS = {}
_LAP = [0.0]


def _lap(label):
    """Records and prints the seconds since the previous lap."""
    now = time.perf_counter()
    PHASE_SECONDS[label] = now - _LAP[0]
    print(f"phase clock: {label} {PHASE_SECONDS[label]:.1f} s")
    _LAP[0] = now


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _kernel_label(mangled):
    """fused_adamw4_kernel<fp32,SR> and the like from a mangled name."""
    m = re.search(r"(fused_adamw4_kernel|rank1_stats_kernel|dequantize_kernel|quantize_kernel)"
                  r"(I.*?E)?E", mangled)
    if not m:
        return mangled
    args = m.group(2) or ""
    dtype = "bf16" if "bfloat16" in args else "fp32" if args.startswith("If") else ""
    mode = "SR" if "Lb1" in args else "RTN" if "Lb0" in args else ""
    args = ",".join(a for a in (dtype, mode) if a)
    return m.group(1) + (f"<{args}>" if args else "")


def _ptxas_report(log):
    """Per kernel: registers, and spill stores/loads, from nvcc's -v output."""
    out, name, mangled, own = {}, None, None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        props = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            name = _kernel_label(mangled)
            out[name] = {}
        elif props:
            own = props.group(1) == mangled
        elif name and own and "spill" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def _sass_functions(lib):
    """{kernel label: its SASS} of a library, the whole listing written to
    chiprun_out; {} without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True).stdout
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / f"sass_{lib.stem}.txt").write_text(sass)
    return {_kernel_label(body.split("\n", 1)[0]): body
            for body in re.split(r"\n\s*Function : ", sass)[1:]}


def _sass_sr_alu_per_element(body):
    """Rotates (funnel shifts) and xors per element in the SR update
    kernel's SASS: both over the Threefry words drawn, counted by their
    rotates by 24 (two in every word, never hoisted or dead)."""
    rot = re.findall(r"SHF\.L\.W\.U32(?:\.HI)? R\d+, R\d+, 0x([0-9a-f]+), R\d+", body)
    xor = re.findall(r"LOP3\.LUT R\d+, R\d+, R\d+, RZ, 0x3c, !PT", body)
    words = rot.count("18") / 2
    return 2 * (len(rot) + len(xor)) / words if words else None


def _sass_loop_per_element(body, elements_per_vote):
    """Instructions per element in the SASS of a kernel's main loop: the
    conditional backward branch whose span holds the most warp votes (one
    vote a step of ``elements_per_vote`` elements a lane; the unconditional
    jumps back from the divergence handlers after the loop do not count),
    every instruction from its target to it counted once, over the elements
    those votes cover. A static count: it includes the few instructions that
    call the out-of-line exact redo, which the fast path branches around.
    None when no such loop is found."""
    code = [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = None
    for addr, ins in code:
        m = re.match(r"@!?U?P\d\s+BRA(?:\.\w+)*\s+(?:\S+,\s*)?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) > addr:
            continue
        span = [i for a, i in code if int(m.group(1), 16) <= a <= addr and not i.startswith("NOP")]
        votes = sum(bool(re.search(r"\bVOTEU?\.ALL\b", i)) for i in span)
        if votes and (best is None or (votes, len(span)) > best):
            best = (votes, len(span))
    return None if best is None else best[1] / (best[0] * elements_per_vote)


def phase_build():
    from repro_torch.kernels import adamw4bit, build, quant4

    t0 = time.perf_counter()
    libs = build.build_libraries(adamw4bit.SOURCE, quant4.SOURCE)
    print(f"built {', '.join(str(p.relative_to(ROOT)) for p in libs)} "
          f"in {time.perf_counter() - t0:.1f} s")
    report = {}
    for lib in libs:
        report.update(_ptxas_report(lib.with_suffix(".log").read_text()))
    for name, r in report.items():
        print(f"ptxas {name}: {r.get('registers')} registers, spill stores "
              f"{r.get('spill_stores')} B, loads {r.get('spill_loads')} B")
    b1_sass, q4_sass = (_sass_functions(lib) for lib in libs)
    sr_body = b1_sass.get("fused_adamw4_kernel<fp32,SR>")
    alu = _sass_sr_alu_per_element(sr_body) if sr_body else None
    print("SASS: the SR update kernel runs " + ("(cuobjdump not found)" if alu is None
                                                else f"{alu:.1f}")
          + f" Threefry rotates and xors per element ({SR_ALU_OPS_PER_ELEMENT} needed)")
    q4_loop = {}
    for dtype in ("fp32", "bf16"):
        body = q4_sass.get(f"quantize_kernel<{dtype}>")
        q4_loop[dtype] = _sass_loop_per_element(body, Q4_ELEMENTS_PER_STEP) if body else None
        print(f"SASS: B2 quantize_kernel<{dtype}> issues "
              + ("(not found)" if q4_loop[dtype] is None else f"{q4_loop[dtype]:.2f}")
              + " instructions per element in its loop (per lane, fast path)")
    return dict(ptxas=report, sass_sr_alu_per_element=alu, sass_q4_per_element=q4_loop)


def _states(shape, sr_on, seed, dev):
    import dataclasses

    import torch

    from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT
    from repro_torch.core.quantizer import quantize

    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(shape, generator=g, device=dev)
    grad = torch.randn(shape, generator=g, device=dev) * 1e-2
    m0 = torch.randn(shape, generator=g, device=dev) * 1e-3
    v0 = torch.randn(shape, generator=g, device=dev).abs() * 1e-5 + 1e-12
    mc = dataclasses.replace(M_4BIT, stochastic_rounding=sr_on)
    vc = dataclasses.replace(V_4BIT, stochastic_rounding=sr_on)
    return w, grad, quantize(m0, mc), quantize(v0, vc)


HP = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
SCAL = dict(lr=1e-3, bc1=0.271, bc2=0.002997)  # step 3 of the default betas


def _compare(shape, k_out, p_out, sr_on):
    """Kernel output against plain output; returns max |dw|."""
    import torch

    for name, a, b in zip(("m codes", "m scales", "v codes"), k_out[1:], p_out[1:]):
        if not torch.equal(a, b):
            diff = (a.to(torch.float64) - b.to(torch.float64)).abs()
            fail(f"{shape} sr={sr_on}: {name} differ at {int((diff > 0).sum())} "
                 f"places (max {float(diff.max())})")
    err = float((k_out[0] - p_out[0]).abs().max())
    if not torch.allclose(k_out[0], p_out[0], rtol=1e-6, atol=0.0):
        fail(f"{shape} sr={sr_on}: params differ (max abs {err})")
    return err


def _leaf_dims(shape):
    R, C = shape[-2], shape[-1]
    n = math.prod(shape)
    return n, n // (R * C), R, C


def _bound(shape):
    """Least time for one update-pass launch on a leaf of ``shape`` (the
    kernel sees (L, R, C), leading dims folded into L): each input read
    once, each output written once (``roofline.measured.b1_update_bytes``),
    against fp32 operations."""
    from repro_torch.roofline.measured import b1_update_bytes

    n, L, R, C = _leaf_dims(shape)
    nbytes = b1_update_bytes(L, R, C)
    flops = 30.0 * n  # dequant, Eq. 1, absmax, two normalisations
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _sr_int_ms(shape, card):
    """Least time of SR's Threefry work on the integer ALU pipe."""
    n = math.prod(shape)
    rate = INT_ALU_LANES_PER_SM * card["sms"] * card["max_sm_mhz"] * 1e6
    return SR_ALU_OPS_PER_ELEMENT * n / rate * 1e3


def _stats_bound(shape):
    """Least time for one stats-pass launch: g and the v codes read once,
    the old stats read and the new ones written once; 10 fp32 operations
    per element (dequant, guard, b2*v + (omb2*g)*g, two maxima); the bytes
    are ``roofline.measured.b1_stats_bytes``."""
    from repro_torch.roofline.measured import b1_stats_bytes

    n, L, R, C = _leaf_dims(shape)
    nbytes = b1_stats_bytes(L, R, C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 10.0 * n / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def _sm_clock():
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def phase_leaves(dev, card):
    """Both passes against their plain versions at every fused leaf shape of
    the main path, RTN and SR, on identical operands; then all timed (the
    update pass: kernel median of 21, plain median of 3, SR; the stats pass
    and the torch prepass: median of 21)."""
    import torch

    from repro_torch.kernels import adamw4bit, ops, sr
    from repro_torch.kernels.timing import event_ms

    rows, max_err, stats_err = [], 0.0, 0.0
    for names, shape, count in LEAF_SHAPES:
        row = dict(leaves=names, shape=list(shape), count=count)
        for sr_on in (False, True):
            w, grad, m_q, v_q = _states(shape, sr_on, 1, dev)
            key = sr.PRNGKey(0) if sr_on else None
            operands, stats = ops.leaf_operands(w, grad, m_q, v_q, HP["b2"], key)
            stats_args = (operands["v_packed"], operands["v_r"], operands["v_c"],
                          operands["g"], operands["v_table"], HP["b2"], shape)
            plain_stats = adamw4bit.rank1_new_stats_plain(*stats_args)
            k_out = adamw4bit.fused_adamw4(**operands, **SCAL, **HP)
            p_out = adamw4bit.fused_adamw4_plain(**operands, **SCAL, **HP)
            torch.cuda.synchronize()
            for d, (a, b) in enumerate(zip(stats, plain_stats)):
                if not torch.equal(a, b):
                    fail(f"{shape} sr={sr_on}: stats pass, dim {d} differs from the torch "
                         f"prepass (max {float((a - b).abs().max())})")
                stats_err = max(stats_err, float((a - b).abs().max()))
            err = _compare(shape, k_out, p_out, sr_on)
            max_err = max(max_err, err)
            print(f"fused_adamw4 {names} {shape} sr={sr_on}: stats bit-equal to the torch "
                  f"prepass; codes and scales bit-equal, max |dw| = {err:.3g}")
            del k_out, p_out, plain_stats
            kernel = lambda: adamw4bit.fused_adamw4(**operands, **SCAL, **HP, out=operands["w"])
            for _ in range(3):
                kernel()
            row["sr_ms" if sr_on else "rtn_ms"] = event_ms(kernel)
            if sr_on:
                row["plain_ms"] = event_ms(
                    lambda: adamw4bit.fused_adamw4_plain(**operands, **SCAL, **HP), 3)
            else:
                row["stats_ms"] = event_ms(lambda: adamw4bit.rank1_new_stats(*stats_args))
                row["prepass_ms"] = event_ms(
                    lambda: adamw4bit.rank1_new_stats_plain(*stats_args))
            del w, grad, m_q, v_q, operands, stats, stats_args
            torch.cuda.empty_cache()
        row["bound_ms"], row["bound_by"], row["bytes"] = _bound(shape)
        row["sr_int_ms"] = _sr_int_ms(shape, card)
        row["sr_bound_ms"] = max(row["bound_ms"], row["sr_int_ms"])
        row["sr_bound_by"] = "bytes" if row["bound_ms"] >= row["sr_int_ms"] else "operations"
        row["stats_bound_ms"], row["stats_bound_by"], row["stats_bytes"] = _stats_bound(shape)
        row["sm_clock"] = _sm_clock()
        print(f"fused_adamw4 {names} {shape} x{count} (SM clock {row['sm_clock']}): "
              f"RTN {row['rtn_ms']:.4f} ms against {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{row['bound_ms'] / row['rtn_ms']:.1%}); SR {row['sr_ms']:.4f} ms against "
              f"{row['sr_bound_ms']:.4f} ms ({row['sr_bound_by']}: bytes {row['bound_ms']:.4f}, "
              f"integer ALU {row['sr_int_ms']:.4f}; {row['sr_bound_ms'] / row['sr_ms']:.1%}); "
              f"plain {row['plain_ms']:.1f} ms")
        print(f"rank1_new_stats {names} {shape} x{count}: kernel {row['stats_ms']:.4f} ms against "
              f"{row['stats_bound_ms']:.4f} ms ({row['stats_bound_by']}, "
              f"{row['stats_bound_ms'] / row['stats_ms']:.1%}); torch prepass "
              f"{row['prepass_ms']:.4f} ms")
        rows.append(row)
    keys = ("sr_ms", "rtn_ms", "plain_ms", "bound_ms", "bytes", "sr_int_ms", "sr_bound_ms",
            "stats_ms", "prepass_ms", "stats_bound_ms", "stats_bytes")
    step = {k: sum(r[k] * r["count"] for r in rows) for k in keys}
    step["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"
    step["sr_bound_by"] = "bytes" if step["bound_ms"] >= step["sr_int_ms"] else "operations"
    step["stats_bound_by"] = ("bytes" if all(r["stats_bound_by"] == "bytes" for r in rows)
                              else "operations")
    step["stats_max_abs_err"] = stats_err
    print(f"fused_adamw4 per step (4 leaves): SR {step['sr_ms']:.4f} ms against "
          f"{step['sr_bound_ms']:.4f} ms ({step['sr_bound_by']}; bytes {step['bound_ms']:.4f} ms, "
          f"{step['bytes'] / 1e9:.2f} GB; integer ALU {step['sr_int_ms']:.4f} ms), "
          f"RTN {step['rtn_ms']:.4f} ms, plain {step['plain_ms']:.1f} ms")
    print(f"rank1_new_stats per step (4 leaves): kernel {step['stats_ms']:.4f} ms against "
          f"{step['stats_bound_ms']:.4f} ms ({step['stats_bytes'] / 1e9:.2f} GB), torch prepass "
          f"{step['prepass_ms']:.4f} ms")
    return max_err, rows, step


def phase_small_reference(dev):
    """Three reduced-config production4bit SR steps from the same weights
    on the card and on the CPU (the CPU runs the plain version)."""
    card, cpu, still, agree = _small_pair("production4bit", 1e-3, "fp32", 0, dev)
    print("reduced production4bit, card / CPU / without steps losses: "
          + ", ".join(f"{a:.6f}/{b:.6f}/{c:.6f}" for a, b, c in zip(card, cpu, still)))
    for a, b in zip(card, cpu):
        if not (math.isfinite(a) and abs(a - b) <= SMALL_RTOL * abs(b)):
            fail(f"reduced run: card losses {card} vs CPU {cpu} (rtol {SMALL_RTOL})")
    if not abs(still[-1] - cpu[-1]) > 5 * SMALL_RTOL * abs(cpu[-1]):
        fail(f"reduced run: the steps moved the loss too little to test ({still} vs {cpu})")
    agree = [agree[f"['4bit'].states[0].inner.m['decoder'][0]['sub0']['mlp']['{w}'].codes"]
             for w in ("w1", "w2", "w3")]
    print(f"reduced production4bit, card vs CPU 4-bit m code agreement (w1, w2, w3): {agree}")
    if min(agree) < 0.9:
        fail(f"reduced run: 4-bit m codes agree at {agree}")
    return dict(card=card, cpu=cpu, without_steps=still, m_code_agreement=agree)


def _reset(counters):
    for c in counters:
        for k in c:
            c[k] = 0


def _read(counters):
    return {k: v for c in counters for k, v in c.items()}


def phase_main_path(counters):
    import torch

    from repro_torch.launch import train

    _reset(counters)
    out = train.main(TRAIN_ARGS)
    counts = _read(counters)
    losses = [r["loss"] for r in out["steps"]]
    for r in out["steps"]:
        print(f"main path step {r['step']}: loss {r['loss']:.4f}  {r['ms']:.1f} ms  "
              f"grad_norm {r['grad_norm']:.3f}")
    print(f"main path: params {out['n_params']:,}  state_bytes {out['state_bytes']:,}  "
          f"peak device memory {out['peak_bytes'] / 1e9:.2f} GB (36.34 GB with the torch "
          f"prepass)  launches {counts}")
    if out["state_bytes"] != STATE_BYTES_INTERNLM2:
        fail(f"state_bytes {out['state_bytes']} != {STATE_BYTES_INTERNLM2}")
    for name in ("fused_adamw4", "rank1_new_stats"):
        if counts[name] != 4 * STEPS:
            fail(f"{name} launched {counts[name]} times, expected {4 * STEPS}")
    if any(abs(a - b) > 1e-4 for a, b in zip(losses, EXPECTED_LOSSES)):
        fail(f"losses {losses} differ from {EXPECTED_LOSSES} beyond four decimals")
    if counts["quantize_blockwise_4bit"] or counts["dequantize_blockwise_4bit"]:
        fail(f"the training path launched the q4 kernels: {counts}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses}")
    peak = out["peak_bytes"]
    steps = out["steps"]
    del out
    torch.cuda.empty_cache()
    return counts, losses, peak, steps


def _check_losses(losses, expected, what):
    if len(losses) != len(expected) or any(abs(a - b) > 1e-4 for a, b in zip(losses, expected)):
        fail(f"{what}: losses {losses} differ from {list(expected)} beyond four decimals")


def phase_checkpoint(counters):
    import gc
    import os

    import torch

    from repro_torch.io import format as ckfmt
    from repro_torch.launch import train

    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shapes, ckpt_bytes = _one_process_manifest()
    free = shutil.disk_usage(d).free
    print(f"checkpoint ({MESH_CKPT_LAYERS} of 24 layers): {free / 1e9:.2f} GB free under "
          f"{d.relative_to(ROOT)}; one save takes {ckpt_bytes:,} B")
    if free < ckpt_bytes:
        fail(f"the disk cannot hold one checkpoint: {free:,} B free, {ckpt_bytes:,} B needed")
    args = MESH_CKPT_ARGS + ["--ckpt-dir", str(d), "--digests"]

    # run A: steps 0-2, the save at step 2
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    a = train.main(args)
    counts_a = _read(counters)
    losses_a = [r["loss"] for r in a["steps"]]
    _check_losses(losses_a, CKPT_LOSSES, "run A")
    for name in ("fused_adamw4", "rank1_new_stats"):
        if counts_a[name] != 4 * len(losses_a):
            fail(f"run A: {name} launched {counts_a[name]} times, expected {4 * len(losses_a)}")
    if ckfmt.latest_step(str(d)) != MESH_CKPT_STEP:
        fail(f"run A: latest complete step {ckfmt.latest_step(str(d))}, "
             f"expected {MESH_CKPT_STEP}")
    step_d = ckfmt.step_dir(str(d), MESH_CKPT_STEP)
    manifest = ckfmt.read_manifest(step_d)
    if manifest["format_version"] != 2 or not os.path.exists(os.path.join(step_d, ckfmt.COMMIT)):
        fail(f"run A: manifest version {manifest['format_version']} or no COMMIT in {step_d}")
    if {k: manifest[k] for k in ("leaves", "structure")} != shapes:
        fail("run A: the manifest's leaves or structure differ from the state's shapes")
    bin_bytes = os.path.getsize(os.path.join(step_d, ckfmt.shard_file(0)))
    if bin_bytes != ckpt_bytes:
        fail(f"run A: shard file {bin_bytes:,} B, the manifest's leaves {ckpt_bytes:,} B")
    save = a["checkpoint"]["saves"][0]
    for r in a["steps"]:
        print(f"run A step {r['step']}: loss {r['loss']:.6f}  {r['ms']:.1f} ms")
    print(f"run A: saved step {MESH_CKPT_STEP}, {len(manifest['leaves'])} leaves, {bin_bytes:,} "
          f"B; save() stalled {save['stall_ms']:.1f} ms ({bin_bytes / save['stall_ms'] / 1e6:.2f} "
          f"GB/s device to host), COMMIT after {save['commit_s']:.2f} s "
          f"({bin_bytes / save['commit_s'] / 1e9:.2f} GB/s)")
    peak_a = a["peak_bytes"]
    step_ms_a = [r["ms"] for r in a["steps"]]
    digests_a = a["digests"]
    del a
    gc.collect()
    torch.cuda.empty_cache()

    # run B: the same command resumes from step 2
    torch.cuda.reset_peak_memory_stats()
    _reset(counters)
    b = train.main(args)
    counts_b = _read(counters)
    ck = b["checkpoint"]
    steps_b = [r["step"] for r in b["steps"]]
    if ck["resumed_from"] != MESH_CKPT_STEP or steps_b != [MESH_CKPT_STEP]:
        fail(f"run B: resumed from {ck['resumed_from']}, ran steps {steps_b}")
    losses_b = [r["loss"] for r in b["steps"]]
    if losses_b != losses_a[MESH_CKPT_STEP:]:
        fail(f"run B: losses {losses_b} differ from run A's {losses_a[MESH_CKPT_STEP:]}")
    for name in ("fused_adamw4", "rank1_new_stats"):
        if counts_b[name] != 4:
            fail(f"run B: {name} launched {counts_b[name]} times, expected 4")
    if counts_b["quantize_blockwise_4bit"] or counts_b["dequantize_blockwise_4bit"]:
        fail(f"run B launched the q4 kernels: {counts_b}")
    digests_b = b["digests"]
    differ = [k for k in digests_a if digests_b.get(k) != digests_a[k]]
    if differ or set(digests_b) != set(digests_a):
        fail(f"run B's final state differs from run A's in {len(differ)} leaves: {differ[:5]}")
    peak_b = b["peak_bytes"]
    for r in b["steps"]:
        print(f"run B step {r['step']}: loss {r['loss']:.6f}  {r['ms']:.1f} ms")
    print(f"run B: resumed from step {ck['resumed_from']}, restore {ck['restore_s']:.2f} s "
          f"({bin_bytes / ck['restore_s'] / 1e9:.2f} GB/s); loss and all {len(digests_b)} final "
          f"leaves equal to run A's; peak device memory {peak_b / 1e9:.2f} GB (run A "
          f"{peak_a / 1e9:.2f} GB); launches {counts_b}")
    if peak_b > peak_a:
        fail(f"run B's peak device memory {peak_b:,} B exceeds run A's {peak_a:,} B")
    step_ms_b = [r["ms"] for r in b["steps"]]
    del b
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d)
    return dict(layers=MESH_CKPT_LAYERS, free_bytes=free, bin_bytes=bin_bytes,
                leaves=len(manifest["leaves"]),
                manifest={k: manifest[k] for k in ("leaves", "structure")},
                save_stall_ms=save["stall_ms"], commit_s=save["commit_s"],
                restore_s=ck["restore_s"], losses_a=losses_a,
                losses_b=losses_b, step_ms_a=step_ms_a, step_ms_b=step_ms_b,
                peak_bytes_a=peak_a, peak_bytes_b=peak_b, launches_b=counts_b)


def _top_kernels(prof, path, n=8):
    """Print the top ``n`` device kernels of a profile by self device time
    (full table to ``path``); returns [(name, ms, count)]."""
    avgs = prof.key_averages()
    self_dev = lambda e: (getattr(e, "self_device_time_total", None)
                          or getattr(e, "self_cuda_time_total", 0))
    kernels = sorted((e for e in avgs if self_dev(e) > 0), key=self_dev, reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    sort_key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
                else "self_cuda_time_total")
    path.write_text(avgs.table(sort_by=sort_key, row_limit=40))
    if not kernels:
        fail(f"the profile ({path.name}) shows no device time")
    top = [(e.key, self_dev(e) / 1e3, e.count) for e in kernels[:n]]
    for key, ms, count in top:
        print(f"  device {ms:8.2f} ms  x{count:<5d} {key[:90]}")
    return top


def phase_profile(dev):
    """Where one full-size step goes: model (forward + backward) against
    optimizer, by CUDA events, and the top device kernels of one step by
    ``torch.profiler`` (table in chiprun_out/step_profile.txt)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import linear_warmup_linear_decay, make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr
    from repro_torch.models import init_model, loss_fn
    from repro_torch.train.train_loop import make_train_state

    cfg = get_config("internlm2-1.8b")
    model = init_model(cfg, seed=0, device=dev)
    opt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, 10))
    state = make_train_state(model, opt, key=sr.PRNGKey(0))
    data = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8))

    def step(t):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
        for p in state.params.values():
            p.grad = None
        ev[0].record()
        loss, _ = loss_fn(model, batch)
        loss.backward()
        ev[1].record()
        grads = {k: p.grad for k, p in state.params.items()}
        with torch.no_grad():
            _, state.opt_state = opt.update(grads, state.opt_state, state.params,
                                            key=sr.fold_in(state.key, t))
        ev[2].record()
        ev[2].synchronize()
        return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])

    for t in range(2):
        step(t)
    model_ms, opt_ms = step(2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(3)
    print(f"step split (CUDA events, step 3): model fwd+bwd {model_ms:.1f} ms, "
          f"optimizer {opt_ms:.1f} ms")
    _top_kernels(prof, OUT_DIR / "step_profile.txt")
    del model, state, prof
    torch.cuda.empty_cache()
    return model_ms, opt_ms


def _special_blocks(x):
    """Flat blocks 0-3 of x (R, C) become a zero block, a NaN block and two
    blocks out of B2's fast division (a scale above 2^60, a subnormal
    element), in place; returns x. (An inf block would give B3 a scale of
    inf and NaN outputs; the card tests cover it.)"""
    flat = x.view(-1, 128)
    flat[0] = 0.0
    flat[1, 5] = float("nan")
    flat[2, 40] = -(2.0**70)
    flat[3, 11] = 1e-40
    return x


def _hold_q4(x, table, what):
    """B2 on ``x`` (R, C) from fp32 and from bf16, and B3 on the fp32 codes
    and scales, each against its plain version on the same card tensors;
    fails unless codes, scales and values are bit-equal. Returns the fp32
    codes and scales and the largest scale and value differences."""
    import torch

    from repro_torch.kernels import quant4

    q_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        xi = x.to(dtype)
        ck, sk = quant4.quantize_blockwise_4bit(xi, table)
        cp, sp = quant4.quantize_blockwise_4bit_plain(xi, table)
        torch.cuda.synchronize()
        if not torch.equal(ck, cp):
            fail(f"B2 {what} {dtype}: codes differ at {int((ck != cp).sum())} bytes")
        if not torch.equal(sk, sp):
            fail(f"B2 {what} {dtype}: scales differ (max {float((sk - sp).abs().max())})")
        q_err = max(q_err, float((sk - sp).abs().max()))
        del xi, ck, sk, cp, sp
    ck, sk = quant4.quantize_blockwise_4bit(x, table)
    yk = quant4.dequantize_blockwise_4bit(ck, sk, table)
    yp = quant4.dequantize_blockwise_4bit_plain(ck, sk, table)
    torch.cuda.synchronize()
    if not torch.equal(yk, yp):
        fail(f"B3 {what}: differs (max {float((yk - yp).abs().max())})")
    return ck, sk, q_err, float((yk - yp).abs().max())


def phase_quant_leaves(dev, card, build_report):
    """B2 and B3 against their plain versions at every q4 leaf shape of
    internlm2-1.8b (the (R, C) view ``prepare_params`` gives the kernel),
    then both timed; sums over the tree's 11 leaves."""
    import torch

    from repro_torch.kernels import quant4
    from repro_torch.kernels.timing import event_ms, per_launch_ms
    from repro_torch.serve.weights import WEIGHT_Q4, kernel_view

    table = WEIGHT_Q4.table("cpu")
    per_element = build_report["sass_q4_per_element"]["fp32"]
    issue_rate = WARP_ISSUE_PER_SM * card["sms"] * card["max_sm_mhz"] * 1e6  # warp instr/s
    rows, err = [], {"q": 0.0, "dq": 0.0}
    for names, shape, count in Q4_LEAVES:
        R, C = kernel_view(shape)
        g = torch.Generator(device=dev).manual_seed(R + C)
        x = _special_blocks(torch.randn((R, C), generator=g, device=dev) * 0.02)
        ck, sk, q_err, dq_err = _hold_q4(x, table, f"{names} {shape}")
        err["q"], err["dq"] = max(err["q"], q_err), max(err["dq"], dq_err)
        n = R * C
        row = dict(leaves=names, shape=list(shape), view=[R, C], count=count)
        for _ in range(3):
            quant4.quantize_blockwise_4bit(x, table)
            quant4.dequantize_blockwise_4bit(ck, sk, table)
        quant = lambda: quant4.quantize_blockwise_4bit(x, table)
        dequant = lambda: quant4.dequantize_blockwise_4bit(ck, sk, table)
        row["q_ms"], row["dq_ms"] = event_ms(quant), event_ms(dequant)
        row["q_b2b_ms"], row["dq_b2b_ms"] = per_launch_ms(quant), per_launch_ms(dequant)
        row["q_plain_ms"] = event_ms(lambda: quant4.quantize_blockwise_4bit_plain(x, table), 3)
        row["dq_plain_ms"] = event_ms(
            lambda: quant4.dequantize_blockwise_4bit_plain(ck, sk, table), 3)
        row["bytes"] = Q4_BYTES_PER_ELEMENT * n
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        # B2 divides, compares and packs a handful of values per byte it
        # moves: bytes bound it, and its own instruction issue is the floor
        # beside that (from the SASS, at the top SM clock)
        row["q_bound_ms"] = t_bytes
        row["q_issue_ms"] = (None if per_element is None else
                             per_element * n / 32 / issue_rate * 1e3)
        row["dq_bound_ms"] = max(t_bytes, 1.0 * n / FP32_FLOPS_PER_S * 1e3)
        row["bound_by"] = "bytes"
        for k in ("q", "dq"):
            gbs = row["bytes"] / (row[f"{k}_ms"] * 1e-3) / 1e9
            row[f"{k}_gbs"] = gbs
        print(f"q4 {names} {shape} as ({R}, {C}) x{count}: "
              f"B2 {row['q_ms']:.4f} ms ({row['q_gbs']:.0f} GB/s, "
              f"{row['q_gbs'] * 1e9 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), "
              f"B3 {row['dq_ms']:.4f} ms ({row['dq_gbs']:.0f} GB/s, "
              f"{row['dq_gbs'] * 1e9 / HBM_BYTES_PER_S:.1%}), bound {row['q_bound_ms']:.4f} ms "
              f"({row['bound_by']}), B2 issue floor {_ms(row['q_issue_ms'])}; "
              f"back to back B2 {row['q_b2b_ms']:.4f}, B3 "
              f"{row['dq_b2b_ms']:.4f} ms a launch; plain B2 {row['q_plain_ms']:.2f} ms, "
              f"B3 {row['dq_plain_ms']:.2f} ms")
        rows.append(row)
        del x, ck, sk
        torch.cuda.empty_cache()
    tree = {k: sum(r[k] * r["count"] for r in rows)
            for k in ("q_ms", "dq_ms", "q_b2b_ms", "dq_b2b_ms", "q_plain_ms", "dq_plain_ms",
                      "q_bound_ms", "dq_bound_ms", "bytes")}
    tree["q_issue_ms"] = (None if per_element is None
                          else sum(r["q_issue_ms"] * r["count"] for r in rows))
    tree["bound_by"] = "bytes"
    print(f"q4 whole tree ({Q4_LEAF_COUNT} leaves, {tree['bytes'] / 1e9:.3f} GB each way): "
          f"B2 {tree['q_ms']:.4f} ms ({tree['q_bound_ms'] / tree['q_ms']:.1%} of the bound), "
          f"B3 {tree['dq_ms']:.4f} ms, bound {tree['q_bound_ms']:.4f} ms (bytes), B2 issue floor "
          f"{_ms(tree['q_issue_ms'])}"
          + ("" if per_element is None else f" ({per_element:.2f} SASS instructions per element)")
          + f"; back to back B2 {tree['q_b2b_ms']:.4f} "
          f"({tree['q_bound_ms'] / tree['q_b2b_ms']:.1%}), B3 {tree['dq_b2b_ms']:.4f} ms; "
          f"plain B2 {tree['q_plain_ms']:.1f} ms, B3 {tree['dq_plain_ms']:.1f} ms; "
          f"codes, scales and values bit-equal to the plain versions")
    return err, rows, tree


def _ms(x):
    return "not measured (no cuobjdump)" if x is None else f"{x:.4f} ms"


def _stream_agreement(a, b):
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    return same / max(1, sum(len(r) for r in a))


def phase_small_serving(dev):
    """q4 serving of the reduced config on the card and on the CPU from the
    same masters: trees bit-equal, logits within SERVE_ATOL, streams'
    agreement recorded."""
    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core.quantizer import QuantizedTensor
    from repro_torch.models import (decode_step, init_model, init_serve_cache, named_params,
                                    prefill_with_cache)
    from repro_torch.serve import Request, ServeEngine, materialize, prepare_params

    cfg = reduced_config("internlm2-1.8b")
    model = init_model(cfg, seed=0, device="cpu")
    masters = {k: p.detach() for k, p in named_params(model).items()}
    rng = np.random.default_rng(1)
    lens = np.array([32, 17, 9, 25])
    toks = rng.integers(0, cfg.vocab_size, size=(4, 32))
    steps = rng.integers(0, cfg.vocab_size, size=(8, 4))  # teacher-forced decode tokens
    prompts = [toks[b, :n].tolist() for b, n in enumerate(lens)]
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        tree = prepare_params({k: v.to(d) for k, v in masters.items()}, "q4")
        p = materialize(tree)
        cache = init_serve_cache(cfg, 4, 256, device=d)
        logits = [prefill_with_cache(p, cfg, torch.from_numpy(toks).to(d),
                                     torch.from_numpy(lens).to(d), cache)[0].cpu()]
        for t in range(steps.shape[0]):
            logits.append(decode_step(p, cfg, cache, torch.from_numpy(steps[t]).to(d),
                                      torch.from_numpy(lens + t).to(d))[0].cpu())
        eng = ServeEngine(cfg, {k: v.to(d) for k, v in masters.items()}, max_batch=2, s_max=256,
                          weights="q4", drain_every=4)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=16,
                        **({} if i % 2 == 0 else dict(temperature=0.8, top_k=40)))
                for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        res[name] = dict(tree=tree, logits=logits, greedy=[r.output for r in reqs[0::2]],
                         sampled=[r.output for r in reqs[1::2]])
    for k, v in res["cpu"]["tree"].items():
        w = res["card"]["tree"][k]
        if isinstance(v, QuantizedTensor):
            if not (torch.equal(w.codes.cpu(), v.codes)
                    and torch.equal(w.scales[0].cpu(), v.scales[0])):
                fail(f"reduced q4 tree: {k} differs between card (B2) and CPU (plain)")
    diffs = [float((a - b).abs().max())
             for a, b in zip(res["card"]["logits"], res["cpu"]["logits"])]
    greedy = _stream_agreement(res["card"]["greedy"], res["cpu"]["greedy"])
    sampled = _stream_agreement(res["card"]["sampled"], res["cpu"]["sampled"])
    print(f"reduced q4 serving, card vs CPU: trees bit-equal; max |dlogit| prefill {diffs[0]:.3g}, "
          f"decode {max(diffs[1:]):.3g} (held to {SERVE_ATOL}); stream agreement greedy "
          f"{greedy:.3f}, sampled {sampled:.3f}")
    if not max(diffs) <= SERVE_ATOL:
        fail(f"reduced q4 serving: card vs CPU logits differ by {diffs}")
    return dict(max_dlogit_prefill=diffs[0], max_dlogit_decode=max(diffs[1:]),
                greedy_agreement=greedy, sampled_agreement=sampled)


def _serve_requests(vocab, new_tokens=SERVE_NEW_TOKENS):
    """The serving mix: prompt lengths from seed 0 in 32..384, random
    tokens, even request ids greedy, odd ones T 0.8 top-k 40, ``new_tokens``
    each."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    lengths = rng.integers(32, 385, size=SERVE_REQUESTS)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)).tolist(),
                    max_new_tokens=new_tokens,
                    **({} if i % 2 == 0 else dict(temperature=0.8, top_k=40)))
            for i, n in enumerate(lengths)]


def phase_serve(counters):
    """The serving path at full size through its CLI's ``main``."""
    from repro_torch.launch import serve

    reqs = _serve_requests(VOCAB)
    _reset(counters)
    out = serve.main(["--arch", "internlm2-1.8b", "--weights", "q4", "--requests",
                      str(SERVE_REQUESTS), "--max-batch", "4", "--max-new-tokens",
                      str(SERVE_NEW_TOKENS), "--drain-every", str(SERVE_DRAIN), "--s-max", "1024",
                      "--seed", "0", "--device", "cuda"], requests=reqs)
    counts = _read(counters)
    eng = out["engine"]
    calls = out["materialize_calls"]
    rep = out["weight_report"]
    n_chunks = calls["decode"]
    # copies: the profile phase runs the same engine on
    prefill_ms, decode_ms = list(eng.phase_ms["prefill"]), list(eng.phase_ms["decode"])
    step_ms = sum(decode_ms) / (n_chunks * SERVE_DRAIN)
    res = dict(weight_bytes=rep["total_serve_bytes"], quantized_leaves=rep["quantized_leaves"],
               launches=counts, materialize_calls=calls, prefill_ms=prefill_ms,
               decode_chunk_ms=decode_ms, decode_ms_per_step=step_ms, tokens=out["tokens"],
               wall_s=out["wall_s"], tok_per_s=out["tokens"] / out["wall_s"],
               peak_bytes=out["peak_bytes"], prompt_lengths=[len(r.prompt) for r in reqs])
    print(f"serve path: {len(reqs)} requests, prompts {res['prompt_lengths']}, "
          f"{out['tokens']} tokens in {out['wall_s']:.2f} s ({res['tok_per_s']:.1f} tok/s); "
          f"prefills {len(prefill_ms)} at {', '.join(f'{m:.1f}' for m in prefill_ms)} ms; "
          f"{n_chunks} decode chunks, {step_ms:.2f} ms per decode step of 4 slots; "
          f"weight bytes {rep['total_serve_bytes']:,}; peak device memory "
          f"{out['peak_bytes'] / 1e9:.2f} GB; launches {counts}")
    if rep["total_serve_bytes"] != WEIGHT_BYTES_Q4 or rep["quantized_leaves"] != Q4_LEAF_COUNT:
        fail(f"weight bytes {rep['total_serve_bytes']} ({rep['quantized_leaves']} q4 leaves), "
             f"expected {WEIGHT_BYTES_Q4} ({Q4_LEAF_COUNT})")
    if counts["quantize_blockwise_4bit"] != Q4_LEAF_COUNT:
        fail(f"B2 launched {counts['quantize_blockwise_4bit']} times, expected {Q4_LEAF_COUNT}")
    expected = Q4_LEAF_COUNT * (calls["prefill"] + calls["decode"])
    if counts["dequantize_blockwise_4bit"] != expected:
        fail(f"B3 launched {counts['dequantize_blockwise_4bit']} times, expected {expected} "
             f"({Q4_LEAF_COUNT} per materialize, {calls})")
    if counts["fused_adamw4"] or counts["rank1_new_stats"]:
        fail(f"the serving path launched the optimizer kernels: {counts}")
    if calls["prefill"] < 2 or len(prefill_ms) != calls["prefill"] or len(decode_ms) != n_chunks:
        fail(f"expected a backfill (two prefills or more) and timed phases: {calls}")
    for r in reqs:
        if not (r.done and len(r.output) == SERVE_NEW_TOKENS
                and all(0 <= t < VOCAB for t in r.output)):
            fail(f"request {r.rid}: done={r.done}, {len(r.output)} tokens")
    return res, eng


def phase_serve_profile(eng):
    """Top device kernels of one decode chunk of the full-size q4 engine."""
    import torch

    for r in _serve_requests(VOCAB)[:4]:
        r.rid += 100
        eng.submit(r)
    eng._admit_and_prefill()
    eng._decode()  # warm
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng._decode()
    print(f"one decode chunk ({SERVE_DRAIN} steps of 4 slots), top device kernels:")
    top = _top_kernels(prof, OUT_DIR / "serve_decode_profile.txt", n=10)
    del prof
    return top


class _StepSplit:
    """CUDA events around the parts of every train step of the CLI runs
    made inside it: the model (from the loss to the gradient wire format or
    the optimizer), the wire format (``reduce_grads``) and the optimizer
    update; and the host time of every batch of Shampoo's inverse roots
    (``transform._inv_quarter_root``: the eigh and the root products,
    synchronised before and after). It wraps the train loop's own names
    for the duration and restores them on exit."""

    def __enter__(self):
        import torch

        from repro_torch.core.optimizers import transform
        from repro_torch.launch import train
        from repro_torch.train import train_loop

        self.steps, self.eigh = [], []
        self._saved = (train.make_optimizer, train_loop.loss_fn, train_loop.reduce_grads,
                       transform._inv_quarter_root)
        make, loss, reduce, roots = self._saved

        def ev():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_loss(*a, **k):
            self.steps.append({"start": ev()})
            return loss(*a, **k)

        def timed_reduce(*a, **k):
            self.steps[-1]["comms0"] = ev()
            out = reduce(*a, **k)
            self.steps[-1]["comms1"] = ev()
            return out

        def timed_make(*a, **k):
            opt = make(*a, **k)

            def update(*ua, **uk):
                self.steps[-1]["opt0"] = ev()
                out = opt.update(*ua, **uk)
                self.steps[-1]["opt1"] = ev()
                return out

            return opt._replace(update=update)

        def timed_roots(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = roots(*a, **k)
            torch.cuda.synchronize()
            self.eigh.append((len(self.steps) - 1, a[0].shape[0], time.perf_counter() - t0))
            return out

        train.make_optimizer, train_loop.loss_fn, train_loop.reduce_grads = (
            timed_make, timed_loss, timed_reduce)
        transform._inv_quarter_root = timed_roots
        return self

    def __exit__(self, *exc):
        from repro_torch.core.optimizers import transform
        from repro_torch.launch import train
        from repro_torch.train import train_loop

        (train.make_optimizer, train_loop.loss_fn, train_loop.reduce_grads,
         transform._inv_quarter_root) = self._saved
        return False

    def split(self):
        """Per step: model, comms and optimizer ms, and the eigh seconds."""
        out = []
        for i, s in enumerate(self.steps):
            model_end = s.get("comms0", s["opt0"])
            out.append({"model_ms": s["start"].elapsed_time(model_end),
                        "comms_ms": (s["comms0"].elapsed_time(s["comms1"])
                                     if "comms0" in s else 0.0),
                        "optimizer_ms": s["opt0"].elapsed_time(s["opt1"]),
                        "eigh_s": sum(t for step, _, t in self.eigh if step == i),
                        "eigh_calls": sum(n for step, n, _ in self.eigh if step == i)})
        return out


class _Depth:
    """The serve CLI's ``--arch`` config (not ``--reduced``) cut to its
    first ``layers`` layers, its width kept, while inside (the serve CLI
    has no ``--layers``); ``None`` leaves it whole."""

    def __init__(self, layers):
        self.layers = layers

    def __enter__(self):
        from repro_torch.configs import cut_depth, get_config
        from repro_torch.launch import serve

        self._saved = serve.get_config
        if self.layers is not None:
            serve.get_config = lambda name: cut_depth(get_config(name), self.layers)
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import serve

        serve.get_config = self._saved
        return False


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else (xs[len(xs) // 2 - 1] + xs[len(xs) // 2]) / 2


def _cli_run(counters, args, layers=None):
    """One CLI run with its launch counts and per-step split; frees it."""
    import gc

    import torch

    from repro_torch.launch import train

    _reset(counters)
    with _StepSplit() as timer:
        out = train.main(args + ([] if layers is None else ["--layers", str(layers)]))
    counts = _read(counters)
    split = timer.split()
    res = dict(optimizer=out["optimizer"], state_bytes=out["state_bytes"],
               n_params=out["n_params"], wire=dict((k, v) for k, v in out["wire"].items()
                                                   if k != "leaves"),
               losses=[r["loss"] for r in out["steps"]],
               ce_losses=[r["ce_loss"] for r in out["steps"]],
               aux_losses=[r["aux_loss"] for r in out["steps"]],
               step_ms=[r["ms"] for r in out["steps"]],
               peak_bytes=out["peak_bytes"], launches=counts, split=split)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _check_trains(res, what):
    losses = res["losses"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{what}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{what}: loss did not fall: {losses}")


def _print_run(res, what):
    for i, (loss, ms, s) in enumerate(zip(res["losses"], res["step_ms"], res["split"])):
        aux = res["aux_losses"][i]
        print(f"{what} step {i}: loss {loss:.4f}"
              + (f" (ce {res['ce_losses'][i]:.4f}, aux {aux:.4f})" if aux else "")
              + f"  {ms:.1f} ms (model {s['model_ms']:.1f}, "
              f"comms {s['comms_ms']:.1f}, optimizer {s['optimizer_ms']:.1f} ms"
              + (f"; inverse roots of {s['eigh_calls']} matrices in {s['eigh_s']:.2f} s"
                 if s["eigh_calls"] else "") + ")")
    print(f"{what}: params {res['n_params']:,}, state_bytes {res['state_bytes']:,}, peak device "
          f"memory {res['peak_bytes']:,} B ({res['peak_bytes'] / 1e9:.2f} GB), launches "
          f"{res['launches']}")


def _eigh_alone(dev, n=EIGH_PROBE):
    """One (n, 128, 128) fp32 batch of SPD matrices decomposed by cuSOLVER
    (``torch.linalg.eigh`` on the card) and by the port's ``host_eigh``
    (copies both ways included), host clock, synchronised: seconds each."""
    import torch

    from repro_torch.core.optimizers.transform import host_eigh

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, 128, 128, generator=g, device=dev)
    a = x @ x.transpose(-1, -2) / 128 + 1e-3 * torch.eye(128, device=dev)
    torch.linalg.eigh(a[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.eigh(a)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    w, u = (y.to(dev) for y in host_eigh(a.cpu()))
    torch.cuda.synchronize()
    return t1 - t0, time.perf_counter() - t1


def phase_new_optimizers(counters, dev):
    """sm3, adafactor, factor4bit and shampoo4bit on their first
    SHAMPOO_LAYERS layers at full width through the CLI, NEW_STEPS steps
    each."""
    import torch

    runs = {}
    for name, lr in NEW_OPTIMIZERS:
        layers = SHAMPOO_LAYERS
        res = _cli_run(counters, NEW_ARGS + ["--optimizer", name, "--lr", str(lr)], layers)
        res["lr"] = lr
        what = f"{name} lr {lr:g}" + (f" ({layers} of 24 layers)" if layers else "")
        _print_run(res, what)
        if res["state_bytes"] != NEW_STATE_BYTES[name]:
            fail(f"{what}: state_bytes {res['state_bytes']:,} != {NEW_STATE_BYTES[name]:,}")
        if any(res["launches"].values()):
            fail(f"{what} launched a kernel no route of it has: {res['launches']}")
        _check_trains(res, what)
        runs[name] = res
    sh = runs["shampoo4bit"]
    probe_s, host_s = _eigh_alone(dev)
    per_matrix_ms = probe_s * 1e3 / EIGH_PROBE
    recompute, stale = sh["step_ms"][0], _median(sh["step_ms"][1:])
    s0 = sh["split"][0]
    sh.update(recompute_ms=recompute, stale_ms=stale, eigh_probe_s=probe_s,
              eigh_per_matrix_ms=per_matrix_ms, host_eigh_probe_s=host_s,
              host_threads=torch.get_num_threads(), torch=torch.__version__,
              cuda=torch.version.cuda)
    print(f"shampoo4bit: recompute step {recompute:.1f} ms against a stale step {stale:.1f} ms "
          f"(median of steps 1-{NEW_STEPS - 1}); step 0 took the inverse roots of "
          f"{s0['eigh_calls']} matrices of at most 128 x 128 in {s0['eigh_s']:.2f} s; alone, "
          f"({EIGH_PROBE}, 128, 128) fp32 took {probe_s:.3f} s in cuSOLVER's eigh "
          f"({per_matrix_ms:.3f} ms a matrix; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}) and {host_s:.3f} s in host_eigh on "
          f"{torch.get_num_threads()} host threads ({host_s * 1e3 / EIGH_PROBE:.3f} ms a matrix)")
    return runs


def _route_logits(router, xg):
    """The router's bf16 logits of grouped tokens, on the host in fp32."""
    import torch

    return torch.einsum("gtd,de->gte", xg.detach(),
                        router.detach().to(torch.bfloat16)).float().cpu()


def _near_ties(c_logits, c_idx, d_logits, d_idx, what):
    """The assignments whose expert choice parts between two runs (``c``
    the recorded one, ``d`` the one held to it); fails unless each parting
    sits at a near tie: the two experts' logits at the first place the
    choices differ lie within two bf16 ulps in one of the runs, or within
    twice the call's largest logit difference between them."""
    ulp = lambda v: 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30))) - 7)
    dlogit = float((c_logits - d_logits).abs().max())
    differs = (c_idx != d_idx).any(dim=-1)
    for g, t in differs.nonzero().tolist():
        j = int((c_idx[g, t] != d_idx[g, t]).nonzero()[0])
        a, b = int(c_idx[g, t, j]), int(d_idx[g, t, j])
        gaps = [abs(float(lg[g, t, a] - lg[g, t, b])) for lg in (c_logits, d_logits)]
        ulps = [gap / ulp(max(abs(float(lg[g, t, a])), abs(float(lg[g, t, b]))))
                for gap, lg in zip(gaps, (c_logits, d_logits))]
        if min(ulps) > 2 and min(gaps) > 2 * dlogit:
            fail(f"{what} away from a tie (max |dlogit| {dlogit:.3g}): group {g} token {t}, "
                 f"experts {c_idx[g, t].tolist()} / {d_idx[g, t].tolist()}, logits "
                 f"{c_logits[g, t].tolist()} / {d_logits[g, t].tolist()}")
    return int((c_idx != d_idx).sum()), dlogit


class _Routes:
    """The MoE routing of one run (a CPU run, phase 42's one-process oracle),
    recorded call by call, and another run held to it: where the second's
    expert choice parts from the first's, the parting must sit at a near
    tie, and the second then takes the first's choice, so both runs follow
    one discrete path. A near tie: the logits of the two experts at the
    first place the choices differ lie within two bf16 ulps in one of the
    runs, or within twice the largest logit difference between the two
    runs in that call (phase 18's rule: after the first step the runs'
    weights differ by their steps' roundings, and the logits with them).
    Data shard ``index`` of ``shards`` holds only its own tokens to the
    recording, and the slots it computes (the lower shards' counts added)
    to the recorded ones, exactly."""

    def __init__(self, calls=None, index=0, shards=1, what="card"):
        self.calls = [] if calls is None else calls
        self.index, self.shards, self.what = index, shards, what
        self.parted, self.dlogit = [], []  # per call held: choices parted, largest |dlogit|
        self.assignments = self.slots_held = 0

    @staticmethod
    @contextlib.contextmanager
    def _patched(choose, slots):
        """``moe_apply`` calls ``choose(real moe_choose, *args)`` and
        ``slots(real moe_slots, *args, **kwargs)`` while inside."""
        import repro_torch.models.moe as moe

        real = moe.moe_choose, moe.moe_slots
        moe.moe_choose = lambda *a: choose(real[0], *a)
        moe.moe_slots = lambda *a, **k: slots(real[1], *a, **k)
        try:
            yield
        finally:
            moe.moe_choose, moe.moe_slots = real

    def record(self):
        def choose(real, router, xg, top_k):
            out = real(router, xg, top_k)
            self.calls.append({"logits": _route_logits(router, xg), "idx": out[2].cpu()})
            return out

        def slots(real, *a, **k):
            out = real(*a, **k)
            self.calls[-1]["slot"] = out.cpu()
            return out

        return self._patched(choose, slots)

    def follow(self):
        import torch

        def mine(n):
            per = n // self.shards
            return slice(self.index * per, (self.index + 1) * per)

        def choose(real, router, xg, top_k):
            probs, top_vals, top_idx = real(router, xg, top_k)
            call = len(self.parted)
            if call >= len(self.calls):
                fail(f"MoE routing: the {self.what} routed more calls than the recording's "
                     f"{len(self.calls)}")
            want = self.calls[call]
            own = mine(want["idx"].shape[1])
            c_idx = want["idx"][:, own]
            self.assignments += c_idx.numel()
            parted, dlogit = _near_ties(
                want["logits"][:, own], c_idx, _route_logits(router, xg)[:, own],
                top_idx.cpu()[:, own],
                f"MoE routing parts the {self.what} (second) from the recording (first): "
                f"call {call}")
            self.parted.append(parted)
            self.dlogit.append(dlogit)
            if parted:
                top_idx = top_idx.clone()
                top_idx[:, own] = c_idx.to(top_idx.device)
                top_vals = torch.gather(probs, -1, top_idx)
                top_vals = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
            return probs, top_vals, top_idx

        def slots(real, *a, **k):
            out = real(*a, **k)
            if k.get("mine") is not None:
                call = len(self.parted) - 1
                want = self.calls[call]["slot"]
                own = mine(want.shape[1])
                if not torch.equal(out.cpu()[:, own], want[:, own]):
                    n = int((out.cpu()[:, own] != want[:, own]).sum())
                    fail(f"MoE mesh slots: call {call} of the {self.what}: {n} of the shard's "
                         f"slots differ from the recording's")
                self.slots_held += want[:, own].numel()
            return out

        return self._patched(choose, slots)


def _small_pair(name, lr, mode, seed, dev, arch="internlm2-1.8b", routes=None):
    """Three reduced-config steps of ``arch`` from the same weights on the
    CPU and the card: losses, the same model's losses without steps, and
    the agreement of the first-moment 4-bit codes. With ``routes`` (a
    ``_Routes``), the CPU run's MoE routing is recorded and the card's held
    to it."""

    import torch

    from repro_torch.comms import CommsConfig
    from repro_torch.configs import reduced_config
    from repro_torch.convert import load_params
    from repro_torch.core.optimizers import linear_warmup_linear_decay, make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.io.tree import flatten_with_keys
    from repro_torch.kernels import sr
    from repro_torch.models import init_model, loss_fn, named_params
    from repro_torch.train.train_loop import build_train_step, make_train_state

    cfg = reduced_config(arch)
    cpu_model = init_model(cfg, seed=0, device="cpu")
    dev_model = init_model(cfg, device="meta").to_empty(device=dev)
    load_params(dev_model, {k: p.detach() for k, p in named_params(cpu_model).items()})
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 4))
    cpu_batch = lambda t: {k: torch.from_numpy(v)
                           for k, v in _with_stub_inputs(cfg, data.batch_at(t), t).items()}
    with torch.no_grad():
        still = [float(loss_fn(cpu_model, cpu_batch(t))[0]) for t in range(3)]
    losses, codes = {}, {}
    for tag, model, d in (("cpu", cpu_model, torch.device("cpu")), ("card", dev_model, dev)):
        opt = make_optimizer(name, linear_warmup_linear_decay(lr, 1, 3))
        state = make_train_state(model, opt, key=sr.PRNGKey(seed) if seed is not None else None)
        step = build_train_step(model, opt, comms=CommsConfig(mode=mode))
        losses[tag] = []
        hold = (contextlib.nullcontext() if routes is None
                else routes.record() if tag == "cpu" else routes.follow())
        with hold:
            for t in range(3):
                state, metrics = step(state, {k: v.to(d) for k, v in cpu_batch(t).items()})
                losses[tag].append(float(metrics["loss"]))
        codes[tag] = {k: v.cpu() for k, v in flatten_with_keys(state.opt_state)
                      if ".m[" in k and k.endswith(".codes")}
    agree = {k: float(torch.cat([(a & 15) == (codes["cpu"][k] & 15),
                                 (a >> 4) == (codes["cpu"][k] >> 4)]).float().mean())
             for k, a in codes["card"].items()}
    return losses["card"], losses["cpu"], still, agree


def phase_small_new(dev):
    """The five new optimizers and production4bit under each quantizing or
    casting wire format, card against CPU on the reduced config."""
    out = {}
    for name, lr, mode, seed, rtol in SMALL_NEW_RUNS:
        card, cpu, still, agree = _small_pair(name, lr, mode, seed, dev)
        what = f"reduced {name} lr {lr:g} grad-comm {mode}" + (f" SR seed {seed}"
                                                              if seed is not None else "")
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        gap = abs(still[-1] - cpu[-1]) / abs(cpu[-1])
        print(f"{what}: card / CPU / without steps losses "
              + ", ".join(f"{a:.6f}/{b:.6f}/{c:.6f}" for a, b, c in zip(card, cpu, still))
              + f"; max relative gap card-CPU {rel:.3g} (held to {rtol:g}), steps moved the "
              f"last loss {gap:.3g}"
              + (f"; 4-bit m code agreement min {min(agree.values()):.4f} over "
                 f"{len(agree)} leaves" if agree else ""))
        if not all(math.isfinite(a) for a in card) or rel > rtol:
            fail(f"{what}: card losses {card} vs CPU {cpu} (rtol {rtol})")
        if not gap > 5 * rtol:
            fail(f"{what}: the steps moved the loss too little to test ({still} vs {cpu})")
        out[f"{name}/{mode}"] = dict(card=card, cpu=cpu, without_steps=still, max_rel=rel,
                                    rtol=rtol, gap=gap, m_code_agreement=agree)
    return out


def phase_comms(counters, main_steps, main_peak):
    """Phase 6's command with --grad-comm int4."""
    res = _cli_run(counters, TRAIN_ARGS + ["--grad-comm", "int4"])
    _print_run(res, "int4 comms")
    wire = res["wire"]
    if wire["total_wire_bytes"] != WIRE_BYTES_INT4 or wire["quantized_leaves"] != 11:
        fail(f"int4 wire bytes {wire['total_wire_bytes']:,} ({wire['quantized_leaves']} "
             f"quantized leaves), expected {WIRE_BYTES_INT4:,} (11)")
    for name in ("fused_adamw4", "rank1_new_stats"):
        if res["launches"][name] != 4 * STEPS:
            fail(f"int4 comms: {name} launched {res['launches'][name]} times, "
                 f"expected {4 * STEPS}")
    if res["launches"]["quantize_blockwise_4bit"] or res["launches"]["dequantize_blockwise_4bit"]:
        fail(f"int4 comms launched the q4 kernels: {res['launches']}")
    if not all(math.isfinite(x) for x in res["losses"]):
        fail(f"int4 comms: non-finite loss {res['losses']}")
    fp32_ms = _median([r["ms"] for r in main_steps[1:]])
    int4_ms = _median(res["step_ms"][1:])
    res.update(step_ms_median=int4_ms, fp32_step_ms_median=fp32_ms, fp32_peak_bytes=main_peak)
    print(f"int4 comms: {wire['total_wire_bytes']:,} wire bytes a step ({wire['ratio_vs_fp32']}x "
          f"fewer than fp32); step {int4_ms:.1f} ms against phase 6's {fp32_ms:.1f} ms (medians "
          f"of steps 1-4); peak {res['peak_bytes']:,} B against phase 6's {main_peak:,} B")
    return res


# ---------------------------------------------------------------------------
# slice 7: qwen3-4b, chatglm3-6b, gemma2-2b
# ---------------------------------------------------------------------------


def _random_leaf(shape, seed, dev):
    """A leaf's B1 operands without a quantize pass: fp32 param and grad,
    random 4-bit m codes with positive B128 scales, random 4-bit v codes with
    positive rank-1 stats (one per dim), so leaves of 1.6 G elements fit."""
    import torch

    from repro_torch.core.optimizers.adamw import M_4BIT, V_4BIT
    from repro_torch.core.quantizer import QuantizedTensor

    g = torch.Generator(device=dev).manual_seed(seed)
    n = math.prod(shape)
    w = torch.randn(shape, generator=g, device=dev)
    grad = torch.randn(shape, generator=g, device=dev) * 1e-2
    codes = lambda: torch.randint(0, 256, shape[:-1] + (shape[-1] // 2,), generator=g,
                                  device=dev, dtype=torch.uint8)
    m = QuantizedTensor(codes(), (torch.rand((n // 128,), generator=g, device=dev) * 1e-3
                                  + 1e-6,), shape, M_4BIT)
    stats = tuple(torch.rand((d,), generator=g, device=dev) * 1e-5 + 1e-9 for d in shape)
    v = QuantizedTensor(codes(), stats, shape, V_4BIT)
    return w, grad, m, v


def _plain_in_chunks(operands, sr_on, shape, chunk=ARCH_PLAIN_CHUNK):
    """B1's two plain versions over a leaf, a run of whole slices at a time
    (each slice's update reads only its own rows, seed and the shared column
    stats; the stats are maxima, merged exactly): (row maxima (L, R), column
    maxima (C,)) of the updated v, and a generator of (slice range, plain
    update outputs)."""
    import torch

    from repro_torch.kernels import adamw4bit, ref

    L, R, C = operands["w"].shape
    step = max(1, chunk // (R * C))
    rows, col = [], None
    for l0 in range(0, L, step):
        sl = slice(l0, min(L, l0 + step))
        v_new = ref.dequant_rank1(operands["v_packed"][sl], operands["v_r"][sl], operands["v_c"],
                                  operands["v_table"].to(operands["w"].device))
        g = operands["g"][sl]
        t = g * (1.0 - HP["b2"])
        t.mul_(g)
        v_new.mul_(HP["b2"]).add_(t)
        del t
        rows.append(torch.amax(v_new, dim=-1))
        c = torch.amax(v_new, dim=(0, 1))
        col = c if col is None else torch.maximum(col, c)
        del v_new

    def updates():
        for l0 in range(0, L, step):
            sl = slice(l0, min(L, l0 + step))
            part = {k: (v[sl] if k in ("w", "g", "m_packed", "m_scale", "v_packed", "v_r",
                                       "v_r_new", "sr_seed") and v is not None else v)
                    for k, v in operands.items()}
            yield sl, adamw4bit.fused_adamw4_plain(**part, **SCAL, **HP)

    return torch.cat(rows), col, updates


def phase_arch_leaves(dev, card, shapes=ARCH_LEAF_SHAPES):
    """Both B1 passes against their plain versions at every leaf shape of
    ``shapes`` (the three dense archs' fused leaves by default), RTN and SR:
    stats bit-equal, codes and scales bit-equal, params within 1e-6
    relative (the plain versions run over runs of whole slices, which is
    exact); then the kernels timed by event pairs against their bounds, and
    summed over each arch's step."""
    import dataclasses

    import torch

    from repro_torch.core.quantizer import QuantizedTensor
    from repro_torch.kernels import adamw4bit, ops, sr
    from repro_torch.kernels.adamw4bit import _dim_stats
    from repro_torch.kernels.timing import event_ms

    rows = []
    for arch, names, shape, count in shapes:
        n, L, R, C = _leaf_dims(shape)
        row = dict(arch=arch, leaves=names, shape=list(shape), count=count, slices=L, rows=R)
        w, grad, m_q, v_q = _random_leaf(shape, 7, dev)
        for sr_on in (False, True):
            key = sr.PRNGKey(0) if sr_on else None
            m_s, v_s = (QuantizedTensor(q.codes, q.scales, q.shape, dataclasses.replace(
                q.config, stochastic_rounding=sr_on)) for q in (m_q, v_q))
            operands, stats = ops.leaf_operands(w, grad, m_s, v_s, HP["b2"], key)
            p_row, p_col, updates = _plain_in_chunks(operands, sr_on, shape)
            plain_stats = _dim_stats(p_row, p_col, shape)
            for d, (a, b) in enumerate(zip(stats, plain_stats)):
                if not torch.equal(a, b):
                    fail(f"{arch} {names} {shape} sr={sr_on}: stats pass dim {d} differs "
                         f"(max {float((a - b).abs().max())})")
            k_out = adamw4bit.fused_adamw4(**operands, **SCAL, **HP)
            err = 0.0
            for sl, p_out in updates():
                err = max(err, _compare(shape, tuple(x[sl] for x in k_out), p_out, sr_on))
            row["max_abs_err"] = max(row.get("max_abs_err", 0.0), err)
            del k_out, p_row, p_col, plain_stats
            kernel = lambda: adamw4bit.fused_adamw4(**operands, **SCAL, **HP, out=operands["w"])
            for _ in range(3):
                kernel()
            row["sr_ms" if sr_on else "rtn_ms"] = event_ms(kernel)
            if not sr_on:
                stats_args = (operands["v_packed"], operands["v_r"], operands["v_c"],
                              operands["g"], operands["v_table"], HP["b2"], shape)
                row["stats_ms"] = event_ms(lambda: adamw4bit.rank1_new_stats(*stats_args))
                del stats_args
            del operands, stats, m_s, v_s
        del w, grad, m_q, v_q
        torch.cuda.empty_cache()
        row["bound_ms"], row["bound_by"], row["bytes"] = _bound(shape)
        row["sr_int_ms"] = _sr_int_ms(shape, card)
        row["sr_bound_ms"] = max(row["bound_ms"], row["sr_int_ms"])
        row["stats_bound_ms"], _, _ = _stats_bound(shape)
        print(f"fused_adamw4 {arch} {names} {shape} as {L} slices of ({R}, {C}) x{count}: both "
              f"passes bit-equal to the plain versions (RTN, SR; max |dw| "
              f"{row['max_abs_err']:.3g}); RTN {row['rtn_ms']:.4f} ms against "
              f"{row['bound_ms']:.4f} ms, SR {row['sr_ms']:.4f} ms against "
              f"{row['sr_bound_ms']:.4f} ms, stats {row['stats_ms']:.4f} ms against "
              f"{row['stats_bound_ms']:.4f} ms")
        rows.append(row)
    per_arch = {}
    for arch in dict.fromkeys(r["arch"] for r in rows):
        mine = [r for r in rows if r["arch"] == arch]
        per_arch[arch] = {k: sum(r[k] * r["count"] for r in mine)
                          for k in ("sr_ms", "rtn_ms", "stats_ms", "sr_bound_ms", "bound_ms",
                                    "stats_bound_ms")}
        per_arch[arch]["leaves"] = sum(r["count"] for r in mine)
        s = per_arch[arch]
        print(f"fused_adamw4 {arch} per step ({s['leaves']} leaves): SR "
              f"{s['sr_ms']:.3f} ms against {s['sr_bound_ms']:.3f} ms, RTN {s['rtn_ms']:.3f} ms "
              f"against {s['bound_ms']:.3f} ms, stats {s['stats_ms']:.3f} ms against "
              f"{s['stats_bound_ms']:.3f} ms")
    return rows, per_arch


def _arch_args(arch, steps=STEPS):
    return ["--arch", arch, "--optimizer", "production4bit", "--sr-seed", "0", "--steps",
            str(steps), "--batch", "8", "--seq", "128", "--device", "cuda"]


def phase_arch_train(counters, table=ARCH_TRAIN):
    """Each arch of ``table`` through the CLI at full width, production4bit
    with SR, ``ARCH_STEPS`` steps of batch 8 x seq 128, at the depth the
    table gives it;
    where it names a probe depth, a 2-step run there first, and the full
    depth's peak extrapolated per layer from the two. MoE archs: their aux
    losses finite and positive."""
    from repro_torch.configs import get_config

    out = {}
    for arch, (full, layers, fused, state_bytes, probe_layers) in table.items():
        res = {}
        if probe_layers:
            probe = _cli_run(counters, _arch_args(arch, 2), probe_layers)
            _check_trains(probe, f"{arch} probe")
            res["probe"] = dict(layers=probe_layers, peak_bytes=probe["peak_bytes"],
                                state_bytes=probe["state_bytes"], step_ms=probe["step_ms"])
        run = _cli_run(counters, _arch_args(arch, ARCH_STEPS), None if layers == full else layers)
        what = f"{arch} at {layers} of {full} layers"
        _print_run(run, what)
        _check_trains(run, what)
        if get_config(arch).num_experts and not all(
                math.isfinite(a) and a > 0 for a in run["aux_losses"]):
            fail(f"{what}: aux losses {run['aux_losses']}")
        if run["state_bytes"] != state_bytes:
            fail(f"{what}: state_bytes {run['state_bytes']:,} != {state_bytes:,}")
        for name in ("fused_adamw4", "rank1_new_stats"):
            if run["launches"][name] != fused * ARCH_STEPS:
                fail(f"{what}: {name} launched {run['launches'][name]} times, expected "
                     f"{fused} a step")
        if (run["launches"]["quantize_blockwise_4bit"]
                or run["launches"]["dequantize_blockwise_4bit"]):
            fail(f"{what} launched the q4 kernels: {run['launches']}")
        res.update(run)
        res["layers"], res["full_layers"] = layers, full
        res["step_ms_median"] = _median(run["step_ms"][1:])
        if probe_layers:
            per_layer = (run["peak_bytes"] - res["probe"]["peak_bytes"]) / (layers - probe_layers)
            res["per_layer_bytes"] = per_layer
            res["full_depth_peak_estimate"] = run["peak_bytes"] + per_layer * (full - layers)
            print(f"{arch}: peak {res['probe']['peak_bytes']:,} B at {probe_layers} layers, "
                  f"{run['peak_bytes']:,} B at {layers}: {per_layer / 1e9:.3f} GB a layer, so "
                  f"~{res['full_depth_peak_estimate'] / 1e9:.1f} GB at {full} layers "
                  f"(the card holds {torch_total_bytes() / 1e9:.1f} GB)")
        split = run["split"][1:]
        res["model_ms_median"] = _median([x["model_ms"] for x in split])
        res["optimizer_ms_median"] = _median([x["optimizer_ms"] for x in split])
        print(f"{what}: step {res['step_ms_median']:.1f} ms (median of steps "
              f"1-{ARCH_STEPS - 1}; model {res['model_ms_median']:.1f}, optimizer "
              f"{res['optimizer_ms_median']:.1f} ms), "
              f"peak {run['peak_bytes'] / 1e9:.2f} GB, B1 {fused} launches of each pass a step")
        out[arch] = res
    return out


def torch_total_bytes():
    import torch

    return torch.cuda.get_device_properties(0).total_memory


def phase_arch_small(dev, archs=tuple(ARCH_TRAIN)):
    """Card against CPU on each arch's reduced config, 3 production4bit SR
    steps from the same weights. MoE archs: the card's routing is held to
    the CPU's (``_Routes``), and the assignments that parted, each at a near
    tie, are counted."""
    from repro_torch.configs import reduced_config

    out = {}
    for arch in archs:
        cfg = reduced_config(arch)
        routes = _Routes() if cfg.num_experts else None
        card, cpu, still, agree = _small_pair("production4bit", 1e-3, "fp32", 0, dev, arch,
                                              routes)
        rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
        gap = abs(still[-1] - cpu[-1]) / abs(cpu[-1])
        print(f"reduced {arch} production4bit: card / CPU / without steps losses "
              + ", ".join(f"{a:.6f}/{b:.6f}/{c:.6f}" for a, b, c in zip(card, cpu, still))
              + f"; max relative gap {rel:.3g} (held to {SMALL_RTOL:g}), steps moved the last "
              f"loss {gap:.3g}; 4-bit m code agreement min {min(agree.values()):.4f} over "
              f"{len(agree)} leaves"
              + (f"; routing: {sum(routes.parted)} of {routes.assignments} expert choices "
                 f"parted card from CPU, each at a near tie (per layer call "
                 f"{routes.parted}; the first step's {cfg.num_layers} calls "
                 f"{sum(routes.parted[:cfg.num_layers])}; largest |dlogit| per call "
                 f"{[round(x, 5) for x in routes.dlogit]})" if routes else ""))
        if not all(math.isfinite(a) for a in card) or rel > SMALL_RTOL:
            fail(f"reduced {arch}: card losses {card} vs CPU {cpu} (rtol {SMALL_RTOL})")
        if not gap > 5 * SMALL_RTOL:
            fail(f"reduced {arch}: the steps moved the loss too little to test")
        out[arch] = dict(card=card, cpu=cpu, without_steps=still, max_rel=rel, gap=gap,
                         m_code_agreement_min=min(agree.values()))
        if routes:
            if len(routes.parted) != len(routes.calls):
                fail(f"reduced {arch}: the card ran {len(routes.parted)} MoE layer calls, the "
                     f"CPU {len(routes.calls)}")
            out[arch].update(routing_parted=routes.parted, routing_assignments=routes.assignments,
                             routing_dlogit=routes.dlogit)
    return out


def _has_kernel_view(shape):
    """Whether B2/B3 take a q4 leaf of this shape (else the plain quantizer)."""
    from repro_torch.serve.weights import kernel_view

    try:
        kernel_view(shape)
    except ValueError:
        return False
    return True


def phase_q4_arch_leaves(dev, table=RECURRENT_SERVE):
    """B2 and B3 against their plain versions at every q4 leaf of each arch
    of ``table`` at full depth that has a kernel view, on the (R, C) view
    ``prepare_params`` gives the kernels (``_hold_q4``, inputs as phase 3's:
    codes, scales and values bit-equal), leaves of one view held once; then
    both kernels timed per view and summed over the tree against the byte
    bound."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import quant4
    from repro_torch.kernels.timing import event_ms
    from repro_torch.models import init_model, named_params
    from repro_torch.serve.weights import DEFAULT_THRESHOLD, WEIGHT_Q4, kernel_view

    q4 = WEIGHT_Q4.table("cpu")
    out = {}
    for arch, (_, _, layers, kernel_leaves) in table.items():
        if layers is not None:
            fail(f"phase 27: {arch} serves at {layers} layers, not at full depth")
        params = named_params(init_model(get_config(arch), device="meta"))
        views = {}
        for path, p in params.items():
            if p.dim() >= 2 and p.numel() > DEFAULT_THRESHOLD and _has_kernel_view(p.shape):
                views.setdefault(kernel_view(tuple(p.shape)), []).append(path)
        n_leaves = sum(len(paths) for paths in views.values())
        if n_leaves != kernel_leaves:
            fail(f"{arch}: {n_leaves} q4 leaves with a kernel view, expected {kernel_leaves}")
        rows = []
        for (R, C), paths in sorted(views.items()):
            g = torch.Generator(device=dev).manual_seed(R + C)
            x = _special_blocks(torch.randn((R, C), generator=g, device=dev) * 0.02)
            codes, scales, _, _ = _hold_q4(x, q4, f"{arch} {paths[0]} as ({R}, {C})")
            rows.append(dict(
                view=[R, C], leaves=paths, count=len(paths),
                q_ms=event_ms(lambda: quant4.quantize_blockwise_4bit(x, q4)),
                dq_ms=event_ms(lambda: quant4.dequantize_blockwise_4bit(codes, scales, q4)),
                bound_ms=Q4_BYTES_PER_ELEMENT * R * C / HBM_BYTES_PER_S * 1e3))
            del x, codes, scales
            torch.cuda.empty_cache()
        tree = {k: sum(r[k] * r["count"] for r in rows) for k in ("q_ms", "dq_ms", "bound_ms")}
        print(f"q4 {arch} at full depth: B2 and B3 bit-equal to the plain versions (codes, "
              f"scales, values; fp32 and bf16 input) at all {len(rows)} kernel views of its "
              f"{n_leaves} q4 leaves with one: "
              + ", ".join(f"({r['view'][0]}, {r['view'][1]}) x{r['count']}" for r in rows)
              + f"; whole tree B2 {tree['q_ms']:.4f} ms, B3 {tree['dq_ms']:.4f} ms against "
              f"{tree['bound_ms']:.4f} ms (bytes)")
        out[arch] = dict(kernel_leaves=n_leaves, views=rows, **tree)
        del params
        gc.collect()
    return out


def phase_arch_serve(counters, table=ARCH_SERVE):
    """Each arch of ``table`` with q4 weights through the serving CLI, at the
    depth the table gives it (``None``: full depth): the mix of phase 8 with
    ``ARCH_SERVE_NEW_TOKENS`` new tokens a request."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.quantizer import QuantizedTensor
    from repro_torch.launch import serve

    out = {}
    for arch, (q4_bytes, q4_leaves, layers, kernel_leaves) in table.items():
        vocab = get_config(arch).vocab_size
        reqs = _serve_requests(vocab, ARCH_SERVE_NEW_TOKENS)
        _reset(counters)
        with _Depth(layers):
            res = serve.main(["--arch", arch, "--weights", "q4", "--requests",
                              str(SERVE_REQUESTS), "--max-batch", "4", "--max-new-tokens",
                              str(ARCH_SERVE_NEW_TOKENS), "--drain-every", str(SERVE_DRAIN),
                              "--s-max", "1024", "--seed", "0", "--device", "cuda"],
                             requests=reqs)
        counts = _read(counters)
        eng, calls, rep = res["engine"], res["materialize_calls"], res["weight_report"]
        with_view = sum(1 for q in eng.params.values()
                        if isinstance(q, QuantizedTensor) and _has_kernel_view(q.shape))
        decode_ms = list(eng.phase_ms["decode"])
        step_ms = sum(decode_ms) / (calls["decode"] * SERVE_DRAIN)
        row = dict(layers=layers or get_config(arch).num_layers,
                   weight_bytes=rep["total_serve_bytes"], quantized_leaves=rep["quantized_leaves"],
                   n_leaves=rep["n_leaves"], kernel_leaves=with_view, launches=counts,
                   materialize_calls=calls,
                   prefill_ms=list(eng.phase_ms["prefill"]), decode_ms_per_step=step_ms,
                   tokens=res["tokens"], wall_s=res["wall_s"],
                   tok_per_s=res["tokens"] / res["wall_s"], peak_bytes=res["peak_bytes"])
        print(f"serve {arch} q4 at {row['layers']} layers: {res['tokens']} tokens in "
              f"{res['wall_s']:.2f} s "
              f"({row['tok_per_s']:.1f} tok/s); prefills "
              f"{', '.join(f'{m:.1f}' for m in row['prefill_ms'])} ms; {step_ms:.2f} ms per "
              f"decode step of 4 slots; weight bytes {rep['total_serve_bytes']:,} "
              f"({rep['quantized_leaves']} of {rep['n_leaves']} leaves q4, {with_view} through "
              f"B2/B3); peak "
              f"{res['peak_bytes'] / 1e9:.2f} GB; launches {counts}")
        if rep["total_serve_bytes"] != q4_bytes or rep["quantized_leaves"] != q4_leaves:
            fail(f"serve {arch}: weight bytes {rep['total_serve_bytes']:,} "
                 f"({rep['quantized_leaves']} q4 leaves), expected {q4_bytes:,} ({q4_leaves})")
        if with_view != kernel_leaves:
            fail(f"serve {arch}: {with_view} q4 leaves have a kernel view, expected "
                 f"{kernel_leaves}")
        if counts["quantize_blockwise_4bit"] != kernel_leaves:
            fail(f"serve {arch}: B2 launched {counts['quantize_blockwise_4bit']} times")
        if counts["dequantize_blockwise_4bit"] != kernel_leaves * (calls["prefill"]
                                                                   + calls["decode"]):
            fail(f"serve {arch}: B3 launched {counts['dequantize_blockwise_4bit']} times, "
                 f"{calls}")
        if counts["fused_adamw4"] or counts["rank1_new_stats"]:
            fail(f"serve {arch} launched the optimizer kernels: {counts}")
        for r in reqs:
            if not (r.done and len(r.output) == ARCH_SERVE_NEW_TOKENS
                    and all(0 <= t < vocab for t in r.output)):
                fail(f"serve {arch}: request {r.rid}: done={r.done}, {len(r.output)} tokens")
        out[arch] = row
        del res, eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_long_window(counters, dev):
    """gemma2-2b, one request alone: a prompt of LONG_PROMPT tokens and
    ARCH_SERVE_NEW_TOKENS new ones through the engine with s_max LONG_S_MAX, so
    the windowed subs' 4096-slot circular caches wrap. The engine's greedy
    tokens against the same request decoded from the same q4 weights with
    LONG_S_MAX slots in every layer (teacher-forced on the engine's tokens,
    so each step's argmax and logits are compared)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_serve_cache, prefill_with_cache
    from repro_torch.models.attention import make_cache
    from repro_torch.models.model import plan_scan_units
    from repro_torch.serve import Request, materialize

    NEW = ARCH_SERVE_NEW_TOKENS
    cfg = get_config("gemma2-2b")
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, size=LONG_PROMPT).tolist()
    req = Request(rid=0, prompt=prompt, max_new_tokens=NEW)
    _reset(counters)
    res = serve.main(["--arch", "gemma2-2b", "--weights", "q4", "--max-batch", "1",
                      "--max-new-tokens", str(NEW), "--drain-every",
                      str(SERVE_DRAIN), "--s-max", str(LONG_S_MAX), "--seed", "0",
                      "--device", dev.type], requests=[req])
    counts = _read(counters)
    eng = res["engine"]
    live = eng.caches[0]
    slots = {sub: int(c.k.shape[2]) for sub, c in live.items()}
    top = {sub: int(c.pos.max()) for sub, c in live.items()}
    window = cfg.blocks[0].window
    if slots["sub0"] != window or slots["sub1"] != LONG_S_MAX:
        fail(f"long request: cache slots {slots}, expected {window} (windowed) and {LONG_S_MAX}")
    if not (req.done and len(req.output) == NEW):
        fail(f"long request: done={req.done}, {len(req.output)} tokens")
    last = LONG_PROMPT + NEW - 2  # the last position the engine wrote and kept
    if top["sub0"] < last or top["sub0"] < window:
        fail(f"long request: the windowed cache holds positions up to {top['sub0']}")
    p = materialize(eng.params)
    units = plan_scan_units(cfg.blocks)
    ref = init_serve_cache(cfg, 1, LONG_S_MAX, device=dev)
    full = [{f"sub{si}": make_cache(1, LONG_S_MAX, cfg.num_kv_heads, cfg.head_dim,
                                    device=dev, layers=u.repeat)
             for si in range(len(u.pattern))} for u in units]
    S = 1
    while S < LONG_PROMPT:
        S *= 2
    toks = torch.zeros((1, S), dtype=torch.int64, device=dev)
    toks[0, :LONG_PROMPT] = torch.tensor(prompt, device=dev)
    lens = torch.tensor([LONG_PROMPT], device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        lw, ref = prefill_with_cache(p, cfg, toks, lens, ref)
        lf, full = prefill_with_cache(p, cfg, toks, lens, full)
        argmax_w, argmax_f = [int(lw.argmax())], [int(lf.argmax())]
        diffs = [float((lw - lf).abs().max())]
        gaps_f = [float(lf.max() - lf[0, req.output[0]])]
        for t in range(NEW - 1):
            tok = torch.tensor([req.output[t]], device=dev)
            pos = torch.tensor([LONG_PROMPT + t], device=dev)
            lw, ref = decode_step(p, cfg, ref, tok, pos)
            lf, full = decode_step(p, cfg, full, tok, pos)
            argmax_w.append(int(lw.argmax()))
            argmax_f.append(int(lf.argmax()))
            diffs.append(float((lw - lf).abs().max()))
            gaps_f.append(float(lf.max() - lf[0, req.output[t + 1]]))
    oracle_s = time.perf_counter() - t0
    same_w = sum(a == b for a, b in zip(argmax_w, req.output))
    same_f = sum(a == b for a, b in zip(argmax_f, req.output))
    # where the full-cache decode picks another token, the engine's token must
    # be within rounding of its best: the two caches hold the same keys (the
    # window masks the full cache's older slots) in another slot order, so
    # their fp32 sums and the bf16 roundings after them differ
    parted = [dict(step=t, engine_token=req.output[t], full_token=argmax_f[t],
                   full_gap=gaps_f[t], dlogit=diffs[t])
              for t in range(NEW) if argmax_f[t] != req.output[t]]
    print(f"long request (gemma2-2b q4): prompt {LONG_PROMPT} + {NEW} new tokens, "
          f"s_max {LONG_S_MAX}: cache slots {slots}, highest positions held {top}; engine "
          f"tokens equal to a windowed-cache decode at {same_w} of {NEW} steps and "
          f"to a decode with {LONG_S_MAX} slots in every layer at {same_f}; max |dlogit| "
          f"windowed vs full cache {max(diffs):.3g} (first decode step {diffs[1]:.3g}); parted "
          f"at {parted}; prefill "
          f"{', '.join(f'{m:.1f}' for m in eng.phase_ms['prefill'])} ms, decode "
          f"{sum(eng.phase_ms['decode']) / max(1, len(eng.phase_ms['decode']) * SERVE_DRAIN):.2f} "
          f"ms a step; peak "
          f"{(res['peak_bytes'] or 0) / 1e9:.2f} GB; launches {counts}")
    if same_w != NEW:
        fail(f"long request: the engine's tokens differ from its own model's decode "
             f"({same_w} of {NEW})")
    for d in parted:
        if not d["full_gap"] <= 2 * d["dlogit"]:
            fail(f"long request: the full-cache decode parts from the engine beyond rounding: {d}")
    out = dict(prompt=LONG_PROMPT, new_tokens=NEW, s_max=LONG_S_MAX, slots=slots,
               top_positions=top, same_windowed=same_w, same_full=same_f, parted=parted,
               max_dlogit_window_vs_full=max(diffs), dlogit_per_step=diffs,
               prefill_ms=eng.phase_ms["prefill"],
               decode_ms=eng.phase_ms["decode"], peak_bytes=res["peak_bytes"],
               oracle_s=oracle_s, launches=counts)
    del res, eng, p, ref, full
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 8: phi3.5-moe-42b-a6.6b, mixtral-8x7b
# ---------------------------------------------------------------------------


def phase_q4_big(dev):
    """B2 and B3 on one whole q4 leaf of more than 2^32 elements (fp32, the
    kernels' (R, C) view of ``BIG_Q4_SHAPE``), each held against its plain
    version on the same slices of its input: windows of ``BIG_Q4_WINDOW``
    elements at the start, around 2^31 and 2^32, and at the end. B128
    blocks are independent, so the comparison is exact: codes, scales and
    dequantized values bit-equal. Both timed by event pairs against the
    byte bound."""
    import gc

    import torch

    from repro_torch.kernels import quant4
    from repro_torch.kernels.timing import event_ms
    from repro_torch.serve.weights import WEIGHT_Q4, kernel_view

    R, C = kernel_view(BIG_Q4_SHAPE)
    n = R * C
    if n <= 1 << 32:
        fail(f"phase 20: {BIG_Q4_SHAPE} holds {n} elements, not more than 2^32")
    table = WEIGHT_Q4.table(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((R, C), generator=g, device=dev)
    codes, scales = quant4.quantize_blockwise_4bit(x, table)
    out = quant4.dequantize_blockwise_4bit(codes, scales, table)
    torch.cuda.synchronize()
    half = BIG_Q4_WINDOW // 2
    windows = [(0, BIG_Q4_WINDOW), ((1 << 31) - half, (1 << 31) + half),
               ((1 << 32) - half, (1 << 32) + half), (n - BIG_Q4_WINDOW, n)]
    flat_x, flat_c, flat_s, flat_o = (t.view(-1) for t in (x, codes, scales, out))
    for a, b in windows:
        pc, ps = quant4.quantize_blockwise_4bit_plain(flat_x[a:b].view(-1, 128), table)
        kc, ks = flat_c[a // 2:b // 2].view(-1, 64), flat_s[a // 128:b // 128].view(-1, 1)
        if not (torch.equal(pc, kc) and torch.equal(ps, ks)):
            fail(f"B2 on {n} elements: window [{a}, {b}) differs from the plain version")
        po = quant4.dequantize_blockwise_4bit_plain(kc, ks, table).view(-1)
        if not torch.equal(po, flat_o[a:b]):
            fail(f"B3 on {n} elements: window [{a}, {b}) differs from the plain version")
        del pc, ps, po
    del out, flat_o  # room for the timed launches' outputs
    nbytes = n * Q4_BYTES_PER_ELEMENT
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    q_ms = event_ms(lambda: quant4.quantize_blockwise_4bit(x, table))
    dq_ms = event_ms(lambda: quant4.dequantize_blockwise_4bit(codes, scales, table))
    res = dict(shape=list(BIG_Q4_SHAPE), view=[R, C], elements=n, windows=windows,
               q_ms=q_ms, dq_ms=dq_ms, bound_ms=bound_ms)
    print(f"q4 past 2^32: {BIG_Q4_SHAPE} as ({R}, {C}), {n:,} elements "
          f"({n / 2 ** 32:.3f} x 2^32): B2 codes and scales and B3 output bit-equal to the "
          f"plain versions on {len(windows)} windows of {BIG_Q4_WINDOW:,} elements (start, "
          f"2^31, 2^32, end); B2 {q_ms:.3f} ms, B3 {dq_ms:.3f} ms against {bound_ms:.3f} ms "
          f"(bytes)")
    del x, codes, scales, flat_x, flat_c, flat_s
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# slice 9: xlstm-125m, hymba-1.5b
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _compute_dtype(dtype):
    """The port's models compute in ``dtype`` within the block: every
    ``repro_torch`` module's ``COMPUTE_DTYPE`` (each binds the name at
    import) set to it, and restored after."""
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.") and hasattr(m, "COMPUTE_DTYPE")]
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = dtype
    try:
        yield
    finally:
        for m, d in zip(mods, old):
            m.COMPUTE_DTYPE = d


def _oracle_pair(params, cfg, prompts, dev, dtype):
    """Logits of a token-by-token decode oracle and of one batched,
    right-padded ``prefill_with_cache`` of ``prompts``, then of four decode
    steps from each cache fed the same tokens (the oracle's argmax), so
    that a near tie cannot send the two down different streams. In the
    oracle a row that has ended keeps its cache as it was, so it holds that
    prompt's state alone. The models compute in ``dtype`` and the K/V
    caches hold it. Returns (per step: (oracle, batched) logits (B, V)),
    the oracle's and the prefill's seconds."""
    import torch

    from repro_torch.models import decode_step, init_serve_cache, prefill_with_cache
    from repro_torch.models.model import cache_leaves, cache_map

    def fresh():
        return cache_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16 else t,
                         init_serve_cache(cfg, B, ORACLE_S_MAX, device=dev))

    B, S = len(prompts), max(len(p) for p in prompts)
    lens = torch.tensor([len(p) for p in prompts], device=dev)
    with torch.no_grad(), _compute_dtype(dtype):
        t0 = time.perf_counter()
        oracle = fresh()
        last = [None] * B
        for t in range(S):
            toks = torch.tensor([p[min(t, len(p) - 1)] for p in prompts], device=dev)
            logits, stepped = decode_step(params, cfg, cache_map(torch.clone, oracle), toks,
                                          torch.full((B,), t, device=dev))
            live = torch.tensor([t < len(p) for p in prompts], device=dev)
            for a, b in zip(cache_leaves(oracle), cache_leaves(stepped)):
                a[:, live] = b[:, live]
            for b, p in enumerate(prompts):
                if t == len(p) - 1:
                    last[b] = logits[b]
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        toks = torch.zeros((B, S), dtype=torch.int64, device=dev)
        for b, p in enumerate(prompts):
            toks[b, :len(p)] = torch.tensor(p, device=dev)
        t0 = time.perf_counter()
        batch = fresh()
        l_batch, batch = prefill_with_cache(params, cfg, toks, lens, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        steps = [(torch.stack(last), l_batch)]
        for t in range(4):
            tok = steps[-1][0].argmax(-1)
            la, oracle = decode_step(params, cfg, oracle, tok, lens + t)
            lb, batch = decode_step(params, cfg, batch, tok, lens + t)
            steps.append((la, lb))
    return steps, oracle_s, prefill_s


def phase_prefill_oracle(dev, archs=(XLSTM, HYMBA)):
    """The reference's ``test_prefill_matches_decode_oracle_archs`` on the
    card, per recurrent arch, random weights from seed 0, two prompts of
    ``ORACLE_LENGTHS`` random tokens (the long one past a GLA chunk, the
    short one padded over 109 steps): the batched prefill and four decode
    steps after it against the token-by-token oracle (``_oracle_pair``),
    every logit of both rows held:

    * at the reduced config (the reference's own setting, 4 layers of width
      64), bf16 compute: within the reference's 5e-2;
    * at full width and depth, fp32 compute: within ``ORACLE_FP32_ATOL``.
      The two paths then differ only in the order they sum in, so a padded
      step that is not an exact identity, an sLSTM state that is not
      frozen or a prefill that parts from the decode shows here;
    * at full width and depth, bf16 compute (what serving runs): within
      ``ORACLE_BF16_ATOL``. The two paths' bf16 activations round apart
      and the gap grows with depth."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_model, named_params

    out = {}
    for arch in archs:
        for size, cfg in (("reduced", reduced_config(arch)), ("full", get_config(arch))):
            rng = np.random.default_rng(4)
            prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in ORACLE_LENGTHS]
            model = init_model(cfg, seed=0, device=dev)
            params = {k: p.detach() for k, p in named_params(model).items()}
            del model
            runs = ((torch.bfloat16, ORACLE_ATOL),) if size == "reduced" else (
                (torch.float32, ORACLE_FP32_ATOL), (torch.bfloat16, ORACLE_BF16_ATOL[arch]))
            for dtype, atol in runs:
                steps, oracle_s, prefill_s = _oracle_pair(params, cfg, prompts, dev, dtype)
                rows = [[float(d) for d in (la - lb).abs().amax(dim=-1)] for la, lb in steps]
                scale = float(steps[0][0].abs().max())
                compute = str(dtype).removeprefix("torch.")
                what = (f"{arch} {size} ({cfg.num_layers} layers, width {cfg.d_model}), "
                        f"{compute} compute")
                print(f"prefill vs token-by-token oracle, {what}, prompts "
                      f"{list(ORACLE_LENGTHS)}: max |dlogit| long / short row, prefill then 4 "
                      f"decode steps: {rows} (logits up to {scale:.6g}; bound {atol:g}); oracle "
                      f"{oracle_s:.1f} s, batched prefill {prefill_s * 1e3:.1f} ms")
                if not all(math.isfinite(x) and x <= atol for r in rows for x in r):
                    fail(f"{what}: batched prefill against the token-by-token oracle: {rows}, "
                         f"bound {atol:g}")
                out[f"{arch}/{size}/{compute}"] = dict(
                    layers=cfg.num_layers, lengths=list(ORACLE_LENGTHS), atol=atol,
                    max_dlogit_long_short=rows, logit_scale=scale, oracle_s=oracle_s,
                    prefill_s=prefill_s)
                del steps
            del params
            gc.collect()
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# slice 10: whisper-large-v3, qwen2-vl-2b
# ---------------------------------------------------------------------------


def _vl_positions(B, S, text, grid, dev):
    """(3, B, S) M-RoPE positions of Qwen2-VL's layout for text around one
    image, the same in every row: ``text`` text tokens (t = h = w), a
    ``grid`` of merged image patches (t = text, h = text + row, w = text +
    col), then text from ``text + max(grid)`` on, all three streams equal."""
    import torch

    gh, gw = grid
    n = gh * gw
    pos = torch.arange(S).repeat(3, 1)
    idx = torch.arange(n)
    pos[0, text:text + n] = text
    pos[1, text:text + n] = text + idx // gw
    pos[2, text:text + n] = text + idx % gw
    pos[:, text + n:] = text + max(gh, gw) + torch.arange(S - text - n)
    return pos[:, None].expand(3, B, S).contiguous().to(dev)


def _with_stub_inputs(cfg, b, t):
    """A numpy token batch with a modality-stub arch's inputs: whisper's
    frames (a normal (B, S, D) from seed ``t``) beside the tokens; in place
    of qwen2-vl's tokens, their rows of a fixed normal (V, D) table as
    embeds (so the labels stay learnable) and M-RoPE positions
    (``_vl_positions``, 4 text tokens around a 3 x 4 grid); other archs'
    batches as they are."""
    import numpy as np

    if cfg.family != "encdec" and cfg.input_mode != "embeds":
        return b
    B, S = b["tokens"].shape
    if cfg.family == "encdec":
        x = np.random.default_rng(t).normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return dict(b, frames=x)
    table = np.random.default_rng(0).normal(size=(cfg.vocab_size, cfg.d_model))
    return {"embeds": table[b["tokens"]].astype(np.float32),
            "positions": _vl_positions(B, S, 4, (3, 4), "cpu").numpy(), "labels": b["labels"]}


def _stub_batch(cfg, embed, B, S, t, dev):
    """Step ``t``'s batch of a modality-stub arch at full size, on the card:
    tokens and labels from the data pipeline (``SyntheticLM``, seed 0);
    whisper: WHISPER_FRAMES frames per row from a torch generator seeded
    with ``t``; qwen2-vl: the tokens' bf16 rows of ``embed``, the image's
    grid of positions replaced by patch embeddings from that generator
    (their labels masked), and the image layout's M-RoPE positions."""
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(cfg.vocab_size, S, B)).batch_at(t)
    tokens = torch.from_numpy(data["tokens"]).to(dev).long()
    labels = torch.from_numpy(data["labels"]).to(dev).long()
    g = torch.Generator(device=dev).manual_seed(1000 + t)
    if cfg.family == "encdec":
        frames = torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=g, device=dev)
        return {"frames": frames.to(torch.bfloat16), "tokens": tokens, "labels": labels}
    embeds = embed.detach().to(torch.bfloat16)[tokens]
    img = slice(VL_TEXT, VL_TEXT + VL_GRID[0] * VL_GRID[1])
    patches = torch.randn((B, img.stop - img.start, cfg.d_model), generator=g, device=dev)
    embeds[:, img] = (patches * 0.02).to(torch.bfloat16)
    labels[:, img] = -1
    return {"embeds": embeds, "positions": _vl_positions(B, S, VL_TEXT, VL_GRID, dev),
            "labels": labels}


def phase_stub_train(counters, dev):
    """Each modality-stub arch at full width and depth through the library's
    training path (``init_model``, ``make_train_state``,
    ``build_train_step``; the CLI refuses them, as the reference's does),
    production4bit with SR seed 0, STEPS steps of ``_stub_batch``, counts
    set to 0 just before and read just after: state bytes (the reference's
    count), the B1 launches of each pass a step, none of B2/B3, losses
    finite and falling; step ms split into model and optimizer, peak
    memory."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import linear_warmup_linear_decay, state_nbytes
    from repro_torch.kernels import sr
    from repro_torch.launch import train
    from repro_torch.models import init_model
    from repro_torch.train.train_loop import build_train_step, make_train_state

    out = {}
    for arch, (fused, state_bytes, B, S) in STUB_TRAIN.items():
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, step_ms = [], []
        _reset(counters)
        with _StepSplit() as timer:
            model = init_model(cfg, seed=0, device=dev)
            # the CLI's optimizer and schedule (train.make_optimizer is the
            # name _StepSplit times)
            opt = train.make_optimizer("production4bit", linear_warmup_linear_decay(
                1e-3, max(1, STEPS // 10), STEPS))
            state = make_train_state(model, opt, key=sr.PRNGKey(0))
            step = build_train_step(model, opt)
            for t in range(STEPS):
                batch = _stub_batch(cfg, model.embed, B, S, t, dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                losses.append(float(metrics["loss"]))  # waits for the whole step
                step_ms.append((time.perf_counter() - t0) * 1e3)
                del batch, metrics
        counts = _read(counters)
        split = timer.split()
        res = dict(batch=B, seq=S, frames=WHISPER_FRAMES if cfg.family == "encdec" else None,
                   n_params=sum(p.numel() for p in state.params.values()),
                   state_bytes=state_nbytes(state.opt_state), losses=losses, step_ms=step_ms,
                   peak_bytes=torch.cuda.max_memory_allocated(dev), launches=counts, split=split)
        del model, opt, state, step
        gc.collect()
        torch.cuda.empty_cache()
        what = f"{arch} (library path, batch {B} x {S}" + (
            f" + {WHISPER_FRAMES} frames)" if cfg.family == "encdec" else ", image layout)")
        for i, (loss, ms, sp) in enumerate(zip(losses, step_ms, split)):
            print(f"{what} step {i}: loss {loss:.4f}  {ms:.1f} ms (model {sp['model_ms']:.1f}, "
                  f"optimizer {sp['optimizer_ms']:.1f} ms)")
        res["step_ms_median"] = _median(step_ms[1:])
        res["model_ms_median"] = _median([x["model_ms"] for x in split[1:]])
        res["optimizer_ms_median"] = _median([x["optimizer_ms"] for x in split[1:]])
        print(f"{what}: params {res['n_params']:,}, state_bytes {res['state_bytes']:,}, step "
              f"{res['step_ms_median']:.1f} ms (median of steps 1-4; model "
              f"{res['model_ms_median']:.1f}, optimizer {res['optimizer_ms_median']:.1f} ms), "
              f"peak {res['peak_bytes']:,} B ({res['peak_bytes'] / 1e9:.2f} GB), launches {counts}")
        _check_trains(res, what)
        if res["state_bytes"] != state_bytes:
            fail(f"{what}: state_bytes {res['state_bytes']:,} != {state_bytes:,}")
        for name in ("fused_adamw4", "rank1_new_stats"):
            if counts[name] != fused * STEPS:
                fail(f"{what}: {name} launched {counts[name]} times, expected {fused} a step")
        if counts["quantize_blockwise_4bit"] or counts["dequantize_blockwise_4bit"]:
            fail(f"{what} launched the q4 kernels: {counts}")
        out[arch] = res
    return out


def phase_stub_serve(counters, dev):
    """Each modality-stub arch served with q4 weights at full width and depth
    through the library (``prepare_params``, ``materialize``, ``encode`` /
    ``prefill``, ``decode_step``; the engine refuses them, as the
    reference's does), STUB_ROWS rows, counts set to 0 just before and read
    just after. whisper: WHISPER_FRAMES frames per row encoded once, then
    ARCH_SERVE_NEW_TOKENS greedy ``decode_step(enc_out=)`` over a cache of
    WHISPER_TOKENS positions (each step projects the cross K/V of all
    frames again, as the reference does). qwen2-vl: ``prefill`` of the
    VL_SEQ-position image prompt, then ARCH_SERVE_NEW_TOKENS greedy steps over a
    cache of VL_SEQ positions from position 0 (the reference carries no
    embeds prompt into a decode cache). As the engine: one ``materialize``
    (B3 per q4 leaf) for the encode or prefill and one per chunk of
    SERVE_DRAIN steps, inside the CUDA events that time them. Checks weight
    bytes and q4 leaves (the reference's ``weight_report``), one B2 launch
    per q4 leaf, B3 per leaf and materialize, no B1, finite logits, tokens
    in the vocabulary."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, encode, init_model, init_serve_cache, prefill
    from repro_torch.models import named_params
    from repro_torch.serve.weights import materialize, prepare_params, weight_report

    out = {}
    for arch, (q4_bytes, q4_leaves, _, kernel_leaves) in STUB_SERVE.items():
        cfg = get_config(arch)
        B, V = STUB_ROWS, cfg.vocab_size
        model = init_model(cfg, seed=0, device=dev)
        masters = {k: p.detach() for k, p in named_params(model).items()}
        embed = masters["embed"]
        shapes = {k: torch.empty(v.shape, device="meta") for k, v in masters.items()}
        g = torch.Generator(device=dev).manual_seed(2000)
        if cfg.family == "encdec":
            prompt = {"frames": torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=g,
                                            device=dev).to(torch.bfloat16)}
        else:
            prompt = _stub_batch(cfg, embed, B, VL_SEQ, 0, dev)
            prompt.pop("labels")
        del model, embed
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset(counters)
        calls, chunk_ms, toks = 0, [], []
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with torch.no_grad():
            q4 = prepare_params(masters, "q4")
            del masters
            start.record()
            params = materialize(q4)
            calls += 1
            if cfg.family == "encdec":
                enc_out = encode(params, cfg, prompt["frames"])
                tok = torch.randint(0, V, (B,), generator=g, device=dev)
                s_max = WHISPER_TOKENS
            else:
                enc_out = None
                tok = prefill(params, cfg, prompt).argmax(-1)
                s_max = VL_SEQ
            end.record()
            end.synchronize()
            first_ms = start.elapsed_time(end)
            del params
            caches = init_serve_cache(cfg, B, s_max, device=dev)
            pos = torch.zeros((B,), dtype=torch.int64, device=dev)
            finite = torch.ones((), dtype=torch.bool, device=dev)
            for _ in range(ARCH_SERVE_NEW_TOKENS // SERVE_DRAIN):
                start.record()
                params = materialize(q4)
                calls += 1
                for _ in range(SERVE_DRAIN):
                    logits, caches = decode_step(params, cfg, caches, tok, pos, enc_out=enc_out)
                    finite &= torch.isfinite(logits).all()
                    tok = logits.argmax(-1)
                    toks.append(tok)
                    pos = pos + 1
                del params
                end.record()
                end.synchronize()
                chunk_ms.append(start.elapsed_time(end))
        counts = _read(counters)
        toks = torch.stack(toks).cpu()
        rep = weight_report(shapes, "q4")
        with_view = sum(1 for q in q4.values() if hasattr(q, "codes") and _has_kernel_view(q.shape))
        step_ms = sum(chunk_ms) / ARCH_SERVE_NEW_TOKENS
        what = (f"serve {arch} q4 ({cfg.num_layers} layers, {B} rows, "
                + (f"{WHISPER_FRAMES} frames encoded" if enc_out is not None
                   else f"prefill of {VL_SEQ} embeds") + ")")
        # first_ms: the encode (whisper) or the prefill (qwen2-vl), with its materialize
        row = dict(rows=B, weight_bytes=rep["total_serve_bytes"],
                   quantized_leaves=rep["quantized_leaves"], n_leaves=rep["n_leaves"],
                   kernel_leaves=with_view, launches=counts, materialize_calls=calls,
                   first_ms=first_ms, decode_chunk_ms=chunk_ms, decode_ms_per_step=step_ms,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   tokens_row0=toks[:, 0].tolist())
        print(f"{what}: {'encode' if enc_out is not None else 'prefill'} {first_ms:.1f} ms "
              f"(with its materialize); {step_ms:.2f} ms per decode step of {B} rows (chunks "
              f"{', '.join(f'{m:.1f}' for m in chunk_ms)} ms of {SERVE_DRAIN} steps with their "
              f"materialize); weight bytes {rep['total_serve_bytes']:,} "
              f"({rep['quantized_leaves']} of {rep['n_leaves']} leaves q4, {with_view} through "
              f"B2/B3); peak {row['peak_bytes']:,} B ({row['peak_bytes'] / 1e9:.2f} GB); "
              f"launches {counts}; row 0's first tokens {row['tokens_row0'][:8]}")
        if rep["total_serve_bytes"] != q4_bytes or rep["quantized_leaves"] != q4_leaves:
            fail(f"{what}: weight bytes {rep['total_serve_bytes']:,} ({rep['quantized_leaves']} "
                 f"q4 leaves), expected {q4_bytes:,} ({q4_leaves})")
        if with_view != kernel_leaves or counts["quantize_blockwise_4bit"] != kernel_leaves:
            fail(f"{what}: {with_view} q4 leaves with a kernel view, B2 launched "
                 f"{counts['quantize_blockwise_4bit']} times; expected {kernel_leaves}")
        if counts["dequantize_blockwise_4bit"] != kernel_leaves * calls:
            fail(f"{what}: B3 launched {counts['dequantize_blockwise_4bit']} times, expected "
                 f"{kernel_leaves} x {calls}")
        if counts["fused_adamw4"] or counts["rank1_new_stats"]:
            fail(f"{what} launched the optimizer kernels: {counts}")
        if not bool(finite) or not bool(((toks >= 0) & (toks < V)).all()):
            fail(f"{what}: non-finite logits or tokens out of the vocabulary")
        out[arch] = row
        del q4, caches, enc_out, prompt
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _teacher_forced_pair(model, cfg, dev, dtype, frames_len):
    """The reference's decode parity checks (``test_encdec_decode_parity``,
    ``test_archs_smoke``'s decode) on the card: STUB_ORACLE_TOKENS tokens
    of STUB_ORACLE_ROWS rows teacher-forced through the whole forward
    against a token-by-token ``decode_step``, computing in ``dtype`` (K/V
    caches too). whisper: frames from a torch generator, the encoder run
    once (``encode``) for the decode; qwen2-vl: ``embeds`` equal to the
    tokens' embedding rows and the default (pure-text) positions. Returns
    per token the largest |dlogit| of each row and the logits' scale."""
    import torch

    from repro_torch.models import decode_step, encode, forward_hidden, init_serve_cache
    from repro_torch.models import named_params
    from repro_torch.models.model import cache_map

    B, S = STUB_ORACLE_ROWS, STUB_ORACLE_TOKENS
    g = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    with torch.no_grad(), _compute_dtype(dtype):
        params = {k: p.detach() for k, p in named_params(model).items()}
        enc_out = None
        if cfg.family == "encdec":
            batch = {"frames": torch.randn((B, frames_len, cfg.d_model), generator=g,
                                           device=dev),
                     "tokens": tokens}
            enc_out = encode(params, cfg, batch["frames"])
        else:
            batch = {"embeds": params["embed"].to(dtype)[tokens]}
        x = forward_hidden(model, batch)
        full = torch.einsum("bsd,dv->bsv", x.to(dtype), model.head_weight().to(dtype)).float()
        caches = cache_map(lambda t: t.to(dtype) if t.dtype == torch.bfloat16 else t,
                           init_serve_cache(cfg, B, 256, device=dev))
        rows = []
        for t in range(S):
            logits, caches = decode_step(params, cfg, caches, tokens[:, t],
                                         torch.full((B,), t, device=dev), enc_out=enc_out)
            rows.append([float(d) for d in (logits - full[:, t]).abs().amax(dim=-1)])
    return rows, float(full.abs().max())


def phase_stub_oracle(dev):
    """Teacher-forced logits against the token-by-token decode
    (``_teacher_forced_pair``), random weights from seed 0, per
    modality-stub arch: at the reduced config (bf16 compute, 20 frames)
    within the reference's 2e-2; at full width and depth (WHISPER_FRAMES
    frames) with fp32 compute within ORACLE_FP32_ATOL (the two paths then
    differ in the order they sum in only) and with bf16 compute within
    STUB_BF16_ATOL (their bf16 roundings part, more with depth)."""
    import gc

    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import init_model

    out = {}
    for arch in (WHISPER, QWEN2VL):
        for size, cfg, frames in (("reduced", reduced_config(arch), 20),
                                  ("full", get_config(arch), WHISPER_FRAMES)):
            model = init_model(cfg, seed=0, device=dev)
            runs = ((torch.bfloat16, STUB_ORACLE_ATOL),) if size == "reduced" else (
                (torch.float32, ORACLE_FP32_ATOL), (torch.bfloat16, STUB_BF16_ATOL[arch]))
            for dtype, atol in runs:
                t0 = time.perf_counter()
                rows, scale = _teacher_forced_pair(model, cfg, dev, dtype, frames)
                secs = time.perf_counter() - t0
                compute = str(dtype).removeprefix("torch.")
                what = (f"{arch} {size} ({cfg.num_layers} layers, width {cfg.d_model}), "
                        f"{compute} compute")
                worst = max(x for r in rows for x in r)
                print(f"teacher-forced vs token-by-token decode, {what}: max |dlogit| per token "
                      f"(rows 0 / 1) {[[round(x, 6) for x in r] for r in rows]}; largest "
                      f"{worst:.6g} (logits up to {scale:.6g}; bound {atol:g}); {secs:.1f} s")
                if not all(math.isfinite(x) and x <= atol for r in rows for x in r):
                    fail(f"{what}: teacher-forced logits against the decode: largest |dlogit| "
                         f"{worst}, bound {atol:g}")
                out[f"{arch}/{size}/{compute}"] = dict(
                    layers=cfg.num_layers, atol=atol, max_dlogit_per_token=rows,
                    max_dlogit=worst, logit_scale=scale, seconds=secs)
            del model
            gc.collect()
            torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 34-36 (slice 11): the mesh path
# ---------------------------------------------------------------------------


def _tile_work(t, box, shape):
    """A tile of a whole-leaf QuantizedTensor in the mesh step's working
    layout: the tile's codes, the whole leaf's scales."""
    from repro_torch.core.quantizer import QuantizedTensor

    cbox = box[:-1] + ((box[-1][0] // 2, box[-1][1] // 2),)
    codes = t.codes.reshape(shape[:-1] + (shape[-1] // 2,))[_index(cbox)].contiguous()
    return QuantizedTensor(codes, t.scales, tuple(b - a for a, b in box), t.config)


def _index(box):
    return tuple(slice(a, b) for a, b in box)


def phase_b1_tiles(dev, leaves=MESH_LEAVES, meshes=TILE_MESHES):
    """Phase 34: B1 on the tiles of internlm2-1.8b's fused leaves under the
    (2, 1), (1, 2) and (2, 2) plans, in one process: pass 1 per tile, the
    per-dim maxima max-merged here, pass 2 per tile with the tile's offsets;
    params, codes, scales and stats bit-equal to one whole-leaf launch of
    each pass, RTN and SR; then the tiles' SR launches timed against the
    whole leaf's. Phase 42 runs it on phi3.5-moe's expert stack under the
    (1, 2) plan (``leaves``, ``meshes``)."""
    import torch

    from repro_torch.kernels import ops, sr
    from repro_torch.kernels.timing import event_ms
    from repro_torch.sharding.context import Tile
    from repro_torch.sharding.rules import wire_spec
    from repro_torch.sharding.specs import local_box

    hp = dict(lr=SCAL["lr"], bc1=SCAL["bc1"], bc2=SCAL["bc2"], **HP)
    rows = []
    for name, shape, axes in leaves:
        C = shape[-1]
        for sr_on in (False, True):
            w, grad, m_q, v_q = _states(shape, sr_on, 2, dev)
            key = sr.PRNGKey(0) if sr_on else None
            whole_w = w.clone()
            _, m2, v2 = ops.fused_adamw4_leaf(whole_w, grad, m_q, v_q, **hp, key=key)
            m2_codes = m2.codes.reshape(shape[:-1] + (C // 2,))
            v2_codes = v2.codes.reshape(shape[:-1] + (C // 2,))
            if sr_on:
                scratch = w.clone()
                whole_ms = event_ms(lambda: ops.fused_adamw4_leaf(scratch, grad, m_q, v_q, **hp,
                                                                  key=key))
                del scratch
            for mesh in meshes:
                sizes = dict(zip(("data", "model"), mesh))
                spec = wire_spec(shape, axes, sizes)
                tiles = [Tile(shape, local_box(spec, shape, dict(zip(sizes, c)), sizes))
                         for c in ((d, m) for d in range(mesh[0]) for m in range(mesh[1]))]
                ops_in = []
                for tile in tiles:
                    idx = _index(tile.box)
                    ops_in.append((tile, w[idx].contiguous(), grad[idx].contiguous(),
                                   _tile_work(m_q, tile.box, shape),
                                   _tile_work(v_q, tile.box, shape)))
                merged = [torch.zeros(n, device=dev) for n in shape]
                for tile, _, g_t, _, v_t in ops_in:
                    for d, st in enumerate(ops.tile_stats(tile, g_t, v_t, HP["b2"])):
                        lo, hi = tile.box[d]
                        merged[d][lo:hi] = torch.maximum(merged[d][lo:hi], st)
                for d, (a, b) in enumerate(zip(merged, v2.scales)):
                    if not torch.equal(a, b):
                        fail(f"B1 tiles {name} {mesh} sr={sr_on}: merged stats of dim {d} differ "
                             "from the whole leaf's")
                elapsed = 0.0
                for tile, w_t, g_t, m_t, v_t in ops_in:
                    p, mp, ms, vp, blk = ops.tile_update(tile, w_t.clone(), g_t, m_t, v_t, merged,
                                                         **hp, key=key)
                    cidx = _index(tile.box[:-1] + ((tile.box[-1][0] // 2,
                                                    tile.box[-1][1] // 2),))
                    for what, a, b in (("params", p, whole_w[_index(tile.box)]),
                                       ("m codes", mp.reshape(m2_codes[cidx].shape),
                                        m2_codes[cidx]),
                                       ("m scales", ms, m2.scales[0][blk]),
                                       ("v codes", vp.reshape(v2_codes[cidx].shape),
                                        v2_codes[cidx])):
                        if not torch.equal(a, b):
                            fail(f"B1 tiles {name} {mesh} sr={sr_on} tile {tile.box}: {what} "
                                 "differ from the whole leaf's")
                    del p, mp, ms, vp
                    if sr_on:
                        elapsed += event_ms(lambda: ops.tile_stats(tile, g_t, v_t, HP["b2"]))
                        elapsed += event_ms(lambda: ops.tile_update(tile, w_t, g_t, m_t, v_t,
                                                                    merged, **hp, key=key))
                print(f"B1 tiles {name} {shape} on {mesh[0]}x{mesh[1]} ({spec}, {len(tiles)} "
                      f"tiles) sr={sr_on}: stats, params, codes and scales bit-equal to the "
                      f"whole leaf's"
                      + (f"; both passes {elapsed:.4f} ms over the tiles against {whole_ms:.4f} "
                         f"ms whole ({elapsed / whole_ms - 1:+.1%})" if sr_on else ""))
                if sr_on:
                    rows.append(dict(leaf=name, shape=list(shape), mesh=list(mesh),
                                     spec=[e if not isinstance(e, tuple) else list(e)
                                           for e in spec],
                                     tiles=len(tiles), tiles_ms=elapsed, whole_ms=whole_ms))
                del ops_in, merged
            del w, grad, m_q, v_q, whole_w, m2, v2, m2_codes, v2_codes
            torch.cuda.empty_cache()
    for mesh in meshes:
        t = sum(r["tiles_ms"] for r in rows if tuple(r["mesh"]) == mesh)
        whole = sum(r["whole_ms"] for r in rows if tuple(r["mesh"]) == mesh)
        print(f"B1 tiles on {mesh[0]}x{mesh[1]}, {', '.join(n for n, _, _ in leaves)}, SR: "
              f"{t:.4f} ms over the tiles against {whole:.4f} ms whole ({t / whole - 1:+.1%})")
    return rows


def _mesh_train(rank, dev, counters):
    """Phase 35 in one rank: the update fed one gradient tree against the
    one-process update (rank 0), then 3 steps of the mesh train step."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import (
        linear_warmup_linear_decay,
        make_optimizer,
        state_nbytes,
    )
    from repro_torch.core.optimizers.base import _leaves
    from repro_torch.core.quantizer import QuantizedTensor
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.sharding.specs import plan_nbytes
    from repro_torch.train.train_loop import build_train_step, make_train_state, shard_train_state

    cfg = get_config("internlm2-1.8b")
    opt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, STEPS))
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    axes = param_axes(cfg)
    key = sr.PRNGKey(0)

    def fresh():
        model = init_model(cfg, seed=0, device=dev)
        state = shard_train_state(make_train_state(model, opt, key=key), mesh, axes)
        return model, state, build_train_step(model, opt, mesh, axes)

    def grads_of(shapes, cut=None):
        gen = torch.Generator(device=dev).manual_seed(7)
        out = {}
        for k, shape in shapes.items():
            g = torch.randn(shape, generator=gen, device=dev) * 1e-3
            out[k] = g[_index(cut[k])].clone() if cut else g
            del g
        return out

    flat = lambda st: [x for leaf in _leaves(st) for x in (
        (leaf.codes, *leaf.scales) if isinstance(leaf, QuantizedTensor) else (leaf,))]
    res = {}
    model, state, fn = fresh()
    ms = fn.mesh_step
    meta = named_params(init_model(cfg, device="meta"))
    res["state_bytes"] = state_nbytes(state.opt_state)
    res["plan_bytes"] = plan_nbytes(opt.init(meta), ms.state_plan, ms.run.coord, ms.run.sizes)
    res["param_bytes"] = sum(p.numel() * 4 for p in state.params.values())
    with torch.no_grad():
        new = ms.update(opt, grads_of(ms.shapes, {k: t.box for k, t in ms.tiles.items()}),
                        state.opt_state, state.params, key=sr.fold_in(key, 0))
        whole_p, whole_s = ms.whole_params(state.params), flat(ms.whole_state(new))
    del model, state, new, fn
    torch.cuda.empty_cache()
    if rank == 0:  # the one-process update of the same state and gradients
        model = init_model(cfg, seed=0, device=dev)
        st = make_train_state(model, opt, key=key)
        with torch.no_grad():  # (the update's params are the model's own)
            one = opt.update(grads_of(ms.shapes), st.opt_state, st.params,
                             key=sr.fold_in(key, 0))[1]
        if not all(torch.equal(p, whole_p[k]) for k, p in st.params.items()):
            fail("mesh update: the params differ from the one-process update")
        mine = flat(one)
        if len(mine) != len(whole_s) or not all(torch.equal(a, b)
                                                for a, b in zip(mine, whole_s)):
            fail("mesh update: the optimizer state differs from the one-process update")
        res["update_leaves_equal"] = len(mine) + len(whole_p)
        del model, st, one, mine
    del whole_p, whole_s
    torch.cuda.empty_cache()
    # the steps end to end, counts from 0 just before and read just after
    model, state, fn = fresh()
    data = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(counters)
    steps = []
    for t in range(MESH_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        steps.append({"step": t, "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                      **fn.times})
    res["launches"] = _read(counters)
    res["steps"] = steps
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["state_bytes_after"] = state_nbytes(state.opt_state)
    return res


def _mesh_tp_train(rank, dev, counters):
    """Phase 40 in one rank: 2 steps on the (data=1, model=2) mesh, the
    compute split over the model axis; counts from 0 just before the steps
    and read just after."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.optimizers import (
        linear_warmup_linear_decay,
        make_optimizer,
        state_nbytes,
    )
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.sharding.specs import plan_nbytes
    from repro_torch.train.train_loop import build_train_step, make_train_state, shard_train_state

    cfg = get_config("internlm2-1.8b")
    opt = make_optimizer("production4bit", linear_warmup_linear_decay(1e-3, 1, STEPS))
    mesh = make_mesh(TP_SHAPE, ("data", "model"))
    axes = param_axes(cfg)
    key = sr.PRNGKey(0)
    model = init_model(cfg, seed=0, device=dev)
    state = shard_train_state(make_train_state(model, opt, key=key), mesh, axes)
    fn = build_train_step(model, opt, mesh, axes)
    ms = fn.mesh_step
    meta = named_params(init_model(cfg, device="meta"))
    res = {"split": sum(d is not None for d in ms.split.values()),
           "gathered": sum(d is None for d in ms.split.values()),
           "state_bytes": state_nbytes(state.opt_state),
           "plan_bytes": plan_nbytes(opt.init(meta), ms.state_plan, ms.run.coord, ms.run.sizes),
           "param_bytes": sum(p.numel() * 4 for p in state.params.values())}
    data = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(counters)
    steps = []
    for t in range(TP_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
        t0 = time.perf_counter()
        state, metrics = fn(state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        steps.append({"step": t, "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                      **fn.times})
    res["launches"] = _read(counters)
    res["steps"] = steps
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    res["state_bytes_after"] = state_nbytes(state.opt_state)
    return res


def _tp_reckoned():
    """Phase 40's cell reckoned on ``meta`` (``roofline.measured.measure``
    walks ``MeshStep.reckon`` with the global batch): its record."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.roofline.measured import measure

    arch, batch, seq, opt_name = ROOFLINE_ARGS
    return measure(get_config(arch), ShapeSpec(f"train_{batch}x{seq}", seq, batch, "train"),
                   dict(zip(("data", "model"), TP_SHAPE)), optimizer=opt_name)


def _partial_times(dev, n=21):
    """The row-parallel products of one (1, 2) rank at phase 40's shapes
    (``wo``: 8 of 16 heads, ``w2``: 4096 of 8192 columns), bf16 operands:
    the partial in fp32 (what the port runs) and in bf16; medians of ``n``
    CUDA-event timings, ms."""
    import torch

    g = torch.Generator(device=dev).manual_seed(5)
    bf = lambda *s: torch.randn(s, generator=g, device=dev).to(torch.bfloat16)
    cases = {"wo": ("bshe,hed->bsd", bf(8, 128, 8, 128), bf(8, 128, 2048)),
             "w2": ("bsf,fd->bsd", bf(8, 128, 4096), bf(4096, 2048))}
    out = {}
    for name, (spec, a, w) in cases.items():
        for kind, fn in (("fp32", lambda: torch.einsum(spec, a.float(), w.float())),
                         ("bf16", lambda: torch.einsum(spec, a, w))):
            fn()
            times = []
            for _ in range(n):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                torch.cuda.synchronize()
                times.append(e0.elapsed_time(e1))
            out[f"{name}_{kind}_ms"] = _median(times)
    return out


def _mesh_all_reduce(rank, dev):
    """Phase 36 in one rank: quantized_all_reduce (int4, SR) on leaves of
    internlm2-1.8b's shapes against the host oracle computed on the card."""
    import hashlib

    import torch
    import torch.distributed as dist

    from repro_torch.comms import CommsConfig, quantized_all_reduce
    from repro_torch.core.quantizer import dequantize, quantize
    from repro_torch.kernels import sr

    qcfg = CommsConfig(mode="int4").quant_config()
    key = sr.PRNGKey(11)
    out = []
    for i, (name, shape) in enumerate(ALL_REDUCE_LEAVES):
        xs = [torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(100 * r + i),
                          device=dev) for r in range(dist.get_world_size())]
        dist.barrier()
        t0 = time.perf_counter()
        got = quantized_all_reduce(xs[rank], qcfg, None, key=key)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        oracle = None
        for r, x in enumerate(xs):  # the host oracle, on the card, in rank order
            u = sr.tensor_uniforms(sr.fold_in(key, r), shape, sr.STREAM_GRAD, dev)
            d = dequantize(quantize(x, qcfg, uniforms=u))
            oracle = d if oracle is None else oracle + d
        if not torch.equal(got, oracle):
            fail(f"quantized_all_reduce {name} {shape}: rank {rank} differs from the oracle")
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        out.append({"leaf": name, "shape": list(shape), "ms": ms, "digest": digest})
    return out


def _moe_mesh_setup(dev):
    """(config, optimizer, SR key, a batch source) of phase 42's runs."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr

    cfg = cut_depth(get_config(MOE_MESH_ARCH), MOE_MESH_LAYERS)
    data = SyntheticLM(DataConfig(cfg.vocab_size, MOE_MESH_SEQ, MOE_MESH_BATCH))
    return cfg, make_optimizer("production4bit", 1e-3), sr.PRNGKey(0), data


def _moe_mesh_oracle(dev, counters, run_dir):
    """Phase 42's oracle in this process, before any rank holds the card:
    the same model, steps and batches in one process; its routing recorded
    for the ranks (``run_dir / moe_routes.pt``)."""
    import torch

    from repro_torch.models import init_model
    from repro_torch.train.train_loop import build_train_step, make_train_state

    cfg, opt, key, data = _moe_mesh_setup(dev)
    model = init_model(cfg, seed=0, device=dev)
    state = make_train_state(model, opt, key=key)
    fn = build_train_step(model, opt)
    routes = _Routes()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(counters)
    steps = []
    for t in range(MOE_MESH_STEPS):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
        t0 = time.perf_counter()
        with routes.record():
            state, m = fn(state, batch)
        steps.append({"loss": float(m["loss"]), "aux": float(m["aux_loss"]),
                      "ms": (time.perf_counter() - t0) * 1e3})
    launches = _read(counters)
    peak = torch.cuda.max_memory_allocated(dev)
    torch.save(routes.calls, run_dir / "moe_routes.pt")
    del model, state, fn, m, batch
    torch.cuda.empty_cache()
    return {"steps": steps, "launches": launches, "peak_bytes": peak, "calls": len(routes.calls),
            "assignments": sum(c["idx"].numel() for c in routes.calls)}


def _mesh_moe(rank, dev, counters, run_dir):
    """Phase 42 in one rank: each layout of ``MOE_MESH_LAYOUTS`` in turn,
    its steps counted from 0 just before and read just after, following the
    one-process routing at near ties (and at (2, 1) holding its shard's
    slots); each layout's collective bytes reckoned on ``meta``."""
    import torch

    from repro_torch.core.optimizers import state_nbytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.sharding.specs import plan_nbytes
    from repro_torch.train.train_loop import build_train_step, make_train_state, shard_train_state

    cfg, opt, key, data = _moe_mesh_setup(dev)
    axes = param_axes(cfg)
    calls = torch.load(run_dir / "moe_routes.pt", weights_only=False)
    meta = named_params(init_model(cfg, device="meta"))
    batches = [data.batch_at(t) for t in range(MOE_MESH_STEPS)]
    out = {}
    for layout in MOE_MESH_LAYOUTS:
        mesh = make_mesh(layout, ("data", "model"))
        # the whole model made on the card, then cut: its storage is freed
        model = init_model(cfg, seed=0, device=dev)
        state = shard_train_state(make_train_state(model, opt, key=key), mesh, axes)
        fn = build_train_step(model, opt, mesh, axes)
        ms = fn.mesh_step
        res = {"split": sorted(k for k, d in ms.split.items() if d is not None),
               "state_bytes": state_nbytes(state.opt_state),
               "plan_bytes": plan_nbytes(opt.init(meta), ms.state_plan, ms.run.coord,
                                         ms.run.sizes),
               "param_bytes": sum(p.numel() * 4 for p in state.params.values()),
               "gathered_layer_bytes": _gathered_layer(ms)}
        index = ms.run.data_ranks.index(ms.run.rank)
        routes = _Routes(calls, index, layout[0], f"data rank {index} at {layout}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset(counters)
        steps = []
        for t, b in enumerate(batches):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            t0 = time.perf_counter()
            with routes.follow():
                state, metrics = fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"step": t, "loss": loss, "aux": float(metrics["aux_loss"]),
                          "ms": (time.perf_counter() - t0) * 1e3, **fn.times})
        res.update(launches=_read(counters), steps=steps,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   state_bytes_after=state_nbytes(state.opt_state), parted=routes.parted,
                   dlogit=routes.dlogit, assignments=routes.assignments,
                   slots_held=routes.slots_held)
        del model, state, fn, ms, metrics, batch
        torch.cuda.empty_cache()
        res["reckoned"] = _reckoned(cfg, opt, key, layout, rank, batches[0])
        out[f"{layout[0]}x{layout[1]}"] = res
    return out


def _gathered_layer(ms):
    """The largest layer a rank of the mesh step ``ms`` gathers (fp32): its
    model shard of a split leaf, any other leaf whole."""
    stacks = {}
    for k, shape in ms.shapes.items():
        if k.startswith(("decoder/", "encoder/")):
            stack = "/".join(k.split("/")[:3])
            stacks[stack] = stacks.get(stack, 0) + math.prod(shape[1:]) * 4 // (
                ms.run.n_tp if ms.split[k] is not None else 1)
    return max(stacks.values())


def _gathered_top(ms):
    """The top-level leaves a rank of the mesh step ``ms`` holds gathered
    through the step (fp32): its model shard of a split leaf, any other
    leaf whole."""
    return sum(math.prod(shape) * 4 // (ms.run.n_tp if ms.split[k] is not None else 1)
               for k, shape in ms.shapes.items() if not k.startswith(("decoder/", "encoder/")))


def _reckoned(cfg, opt, key, layout, rank, batch):
    """The collective bytes of one step of rank ``rank`` on ``layout``,
    reckoned with no world on its ``meta`` parts (``MeshStep.reckon``;
    ``batch``: one global batch of numpy arrays, for its shapes)."""
    import torch

    from repro_torch.comms import CommsConfig
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.roofline.measured import Counter
    from repro_torch.sharding.context import MeshRun
    from repro_torch.sharding.specs import local_slice, map_plan
    from repro_torch.train.mesh import MeshStep

    meta = named_params(init_model(cfg, device="meta"))
    with torch.no_grad():
        meta_state = opt.init(meta)
    run = MeshRun(dict(zip(("data", "model"), layout)), rank=rank)
    dry = MeshStep(run, cfg, {k: tuple(p.shape) for k, p in meta.items()}, param_axes(cfg), meta,
                   meta_state)
    cut = lambda t, spec: local_slice(t, spec, run.coord, run.sizes).clone()
    local = {k: cut(p, dry.param_plan[k]) for k, p in meta.items()}
    parts = map_plan(cut, meta_state, dry.state_plan)
    shapes = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype, device="meta")
              for k, v in batch.items()}
    with Counter():
        return dry.reckon(local, parts, opt, key, 1, CommsConfig(), batch=shapes)[0]


def _mesh_optim(rank, dev, counters):
    """Phase 39 in one rank: each of ``NEW_OPTIMIZERS`` on the (data=2,
    model=1) mesh through ``build_train_step``, as the train CLI's ``--mesh
    2x1`` runs it at phase 11's depth, learning rates and steps; counts from
    0 just before each run's steps and read just after."""
    import torch

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.core.optimizers import (
        linear_warmup_linear_decay,
        make_optimizer,
        state_nbytes,
    )
    from repro_torch.core.optimizers.transform import EIGH
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, param_axes
    from repro_torch.train.train_loop import build_train_step, make_train_state, shard_train_state

    cfg = cut_depth(get_config("internlm2-1.8b"), SHAMPOO_LAYERS)
    mesh = make_mesh(MESH_SHAPE, ("data", "model"))
    axes = param_axes(cfg)
    data = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8))
    out = {}
    for name, lr in NEW_OPTIMIZERS:
        t_run = time.perf_counter()
        # the CLI's schedule: warmup over a tenth of the steps, decay over all
        opt = make_optimizer(name, linear_warmup_linear_decay(lr, max(1, NEW_STEPS // 10),
                                                              NEW_STEPS))
        model = init_model(cfg, seed=0, device=dev)
        state = shard_train_state(make_train_state(model, opt), mesh, axes)
        fn = build_train_step(model, opt, mesh, axes)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset(counters)
        steps, eigh = [], []
        for t in range(NEW_STEPS):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
            e0 = dict(EIGH)
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"step": t, "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                          **fn.times})
            eigh.append({k: EIGH[k] - e0[k] for k in EIGH})
        out[name] = {"steps": steps, "eigh": eigh, "launches": _read(counters),
                     "state_bytes": state_nbytes(state.opt_state),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        del model, state, fn, metrics, batch
        torch.cuda.empty_cache()
        out[name]["seconds"] = time.perf_counter() - t_run
    return out


def _recurrent_mesh_setup(arch, layers):
    """(config, optimizer, SR key, a batch source) of phase 43's runs of
    ``arch`` (at its first ``layers`` layers, or whole)."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import sr

    cfg = get_config(arch) if layers is None else cut_depth(get_config(arch), layers)
    data = SyntheticLM(DataConfig(cfg.vocab_size, RECURRENT_MESH_SEQ, RECURRENT_MESH_BATCH))
    return cfg, make_optimizer("production4bit", 1e-3), sr.PRNGKey(0), data


def _recurrent_mesh_oracle(dev, counters):
    """Phase 43's oracle in this process, before any rank holds the card:
    each arch's same steps on the same batches in one process."""
    import torch

    from repro_torch.models import init_model
    from repro_torch.train.train_loop import build_train_step, make_train_state

    out = {}
    for arch, layers in RECURRENT_MESH:
        cfg, opt, key, data = _recurrent_mesh_setup(arch, layers)
        model = init_model(cfg, seed=0, device=dev)
        state = make_train_state(model, opt, key=key)
        fn = build_train_step(model, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset(counters)
        steps = []
        for t in range(RECURRENT_MESH_STEPS):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(t).items()}
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            steps.append({"loss": float(m["loss"]), "ms": (time.perf_counter() - t0) * 1e3})
        out[arch] = {"steps": steps, "launches": _read(counters),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev)}
        del model, state, fn, m, batch
        torch.cuda.empty_cache()
    return out


def _mesh_recurrent(rank, dev, counters):
    """Phase 43 in one rank: each arch of ``RECURRENT_MESH`` on the
    ``RECURRENT_MESH_LAYOUT`` mesh, its recurrent blocks on the rank's heads,
    states or rows, its attention, lookup and cross entropy in the
    ``embed``-cut modes where the rules cut those leaves on ``embed``; its
    steps and the modes' calls counted from 0 just before and read just
    after; its collective bytes reckoned on ``meta``."""
    import torch

    from repro_torch.core.optimizers import state_nbytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.sharding import tensor_parallel as tp_lib
    from repro_torch.sharding.specs import plan_nbytes
    from repro_torch.train.train_loop import build_train_step, make_train_state, shard_train_state

    out = {}
    for arch, layers in RECURRENT_MESH:
        cfg, opt, key, data = _recurrent_mesh_setup(arch, layers)
        axes = param_axes(cfg)
        mesh = make_mesh(RECURRENT_MESH_LAYOUT, ("data", "model"))
        model = init_model(cfg, seed=0, device=dev)
        state = shard_train_state(make_train_state(model, opt, key=key), mesh, axes)
        fn = build_train_step(model, opt, mesh, axes)
        ms = fn.mesh_step
        meta = named_params(init_model(cfg, device="meta"))
        res = {"split": sum(d is not None for d in ms.split.values()),
               "gathered": sum(d is None for d in ms.split.values()),
               "state_bytes": state_nbytes(state.opt_state),
               "plan_bytes": plan_nbytes(opt.init(meta), ms.state_plan, ms.run.coord,
                                         ms.run.sizes),
               "param_bytes": sum(p.numel() * 4 for p in state.params.values()),
               "gathered_layer_bytes": _gathered_layer(ms),
               "gathered_top_bytes": _gathered_top(ms)}
        batches = [data.batch_at(t) for t in range(RECURRENT_MESH_STEPS)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset(counters)
        tp_lib.CALLS.update(dict.fromkeys(tp_lib.CALLS, 0))
        steps = []
        for t, b in enumerate(batches):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            t0 = time.perf_counter()
            state, metrics = fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            steps.append({"step": t, "loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
                          **fn.times})
        res.update(launches=_read(counters), calls=dict(tp_lib.CALLS), steps=steps,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   state_bytes_after=state_nbytes(state.opt_state))
        del model, state, fn, ms, metrics, batch
        torch.cuda.empty_cache()
        res["reckoned"] = _reckoned(cfg, opt, key, RECURRENT_MESH_LAYOUT, rank, batches[0])
        out[arch] = res
    return out


def _mesh_child(rank, world, run_dir, parts):
    """One rank of the mesh phases (``parts`` of ``MESH_PARTS``, in order):
    ``cuda:0`` shared with the other rank, gloo through a FileStore in
    ``run_dir``; results to ``rank<r>.json``."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import adamw4bit, quant4

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(run_dir, "rendezvous"),
                            rank=rank, world_size=world)
    try:
        from repro_torch.comms.collectives import open_host_slots

        open_host_slots()
        counters = (adamw4bit.LAUNCHES, quant4.LAUNCHES)
        run = {"train": lambda: _mesh_train(rank, dev, counters),
               "all_reduce": lambda: _mesh_all_reduce(rank, dev),
               "tp": lambda: _mesh_tp_train(rank, dev, counters),
               "optim": lambda: _mesh_optim(rank, dev, counters),
               "moe": lambda: _mesh_moe(rank, dev, counters, Path(run_dir)),
               "recurrent": lambda: _mesh_recurrent(rank, dev, counters)}
        res = {"seconds": {}}
        for part in parts:
            t0 = time.perf_counter()
            res[part] = run[part]()
            res["seconds"][part] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        with open(os.path.join(run_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def phase_mesh(parts=MESH_PARTS, new_optimizers=None):
    """The mesh phases that share phase 35's two processes on ``cuda:0``
    over gloo (NCCL refuses two ranks on one device; gloo moves CUDA tensors
    through host memory): 35 (``train``), 36 (``all_reduce``), 40
    (``tp``), 39 (``optim``: held to phase 11's ``new_optimizers``), 42
    (``moe``) and 43 (``recurrent``), those of ``parts``. The one-process
    oracles of phases 42 and 43 and phase 42's B1 tiles run here first,
    while no rank holds the card."""
    import torch
    import torch.multiprocessing as mp

    from repro_torch.kernels import adamw4bit, quant4

    run_dir = ROOT / "build" / "mesh_smoke"
    shutil.rmtree(run_dir, ignore_errors=True)
    run_dir.mkdir(parents=True)
    dev = torch.device("cuda", 0)
    counters = (adamw4bit.LAUNCHES, quant4.LAUNCHES)
    if "moe" in parts:
        t42 = time.perf_counter()
        oracle = _moe_mesh_oracle(dev, counters, run_dir)
        moe_tiles = phase_b1_tiles(dev, MOE_TILE_LEAVES, ((1, 2),))
        t42 = time.perf_counter() - t42
    if "recurrent" in parts:
        t43 = time.perf_counter()
        rec_oracle = _recurrent_mesh_oracle(dev, counters)
        t43 = time.perf_counter() - t43
    torch.cuda.empty_cache()
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    print(f"mesh data={MESH_SHAPE[0]} model={MESH_SHAPE[1]}: {world} processes on cuda:0, "
          "backend gloo (collectives copy CUDA tensors through host memory)")
    t0 = time.perf_counter()
    try:
        mp.spawn(_mesh_child, args=(world, str(run_dir), tuple(parts)), nprocs=world, join=True)
    except Exception as e:  # a rank's failure, with its traceback
        fail(f"mesh phases: {e}")
    wall = time.perf_counter() - t0
    ranks = [json.loads((run_dir / f"rank{r}.json").read_text()) for r in range(world)]
    seconds = {part: max(r["seconds"][part] for r in ranks) for part in parts}
    out = {"seconds": wall, "part_seconds": seconds}
    if "moe" in parts:
        out["moe"] = _check_mesh_moe(ranks, oracle, moe_tiles, t42)
    if "train" in parts:
        out.update(_check_mesh_train(ranks))
    if "tp" in parts:
        out["tp"] = _check_mesh_tp(ranks)
    if "optim" in parts:
        out["optim"] = _check_mesh_optim(ranks, new_optimizers)
    if "recurrent" in parts:
        out["recurrent"] = _check_mesh_recurrent(ranks, rec_oracle, t43)
    print(f"mesh phases ({', '.join(parts)}): {wall:.1f} s with both processes' start; in the "
          "ranks: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
    return out


def _check_mesh_train(ranks):
    """Phases 35 and 36's checks and prints."""
    launches = {}
    for r, res in enumerate(ranks):
        tr = res["train"]
        if tr["state_bytes"] != tr["plan_bytes"] or tr["state_bytes_after"] != tr["plan_bytes"]:
            fail(f"rank {r}: state bytes {tr['state_bytes']} / {tr['state_bytes_after']} != the "
                 f"plan's {tr['plan_bytes']}")
        for k, v in tr["launches"].items():
            launches[k] = launches.get(k, 0) + v
        losses = [s["loss"] for s in tr["steps"]]
        for a, b in zip(losses, EXPECTED_LOSSES):
            if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
                fail(f"rank {r}: mesh losses {losses} not within 1e-4 relative of phase 6's "
                     f"{EXPECTED_LOSSES[:MESH_STEPS]}")
        for s in tr["steps"]:
            coll = s["collective_fwd_bwd_s"] + s["collective_update_s"]
            print(f"mesh rank {r} step {s['step']}: loss {s['loss']:.4f}  {s['ms']:.1f} ms "
                  f"(compute {1e3 * (s['fwd_bwd_s'] - s['collective_fwd_bwd_s']):.1f}, "
                  f"collective {1e3 * coll:.1f}, update "
                  f"{1e3 * (s['update_s'] - s['collective_update_s']):.1f} ms; "
                  f"{s['collective_bytes'] / 1e9:.2f} GB through the collectives)")
        print(f"mesh rank {r}: state_bytes {tr['state_bytes']:,} (the plan's "
              f"{tr['plan_bytes']:,}), param_bytes {tr['param_bytes']:,}, peak "
              f"{tr['peak_bytes']:,} B ({tr['peak_bytes'] / 1e9:.2f} GB), launches "
              f"{tr['launches']}")
    if ranks[0]["train"].get("update_leaves_equal") is None:
        fail("mesh update: the one-process comparison did not run")
    print(f"mesh update fed one gradient tree: {ranks[0]['train']['update_leaves_equal']} "
          "params and state tensors bit-equal to the one-process update on the card")
    for name in ("fused_adamw4", "rank1_new_stats"):
        if launches[name] != 4 * MESH_STEPS * len(ranks):
            fail(f"mesh: {name} launched {launches[name]} times, expected "
                 f"{4 * MESH_STEPS * len(ranks)} (4 leaves a step on each rank's tiles)")
    if launches["quantize_blockwise_4bit"] or launches["dequantize_blockwise_4bit"]:
        fail(f"mesh: the training path launched the q4 kernels: {launches}")
    # phase 36
    for a, b in zip(*(res["all_reduce"] for res in ranks)):
        if a["digest"] != b["digest"]:
            fail(f"quantized_all_reduce {a['leaf']}: the ranks' bits differ")
    for row in ranks[0]["all_reduce"]:
        print(f"quantized_all_reduce int4+SR {row['leaf']} {tuple(row['shape'])}: both ranks "
              f"bit-equal to the host oracle on the card, {row['ms']:.1f} ms on rank 0")
    return {"launches": launches,
            "ranks": [{k: r[k] for k in ("train", "all_reduce")} for r in ranks]}


def _check_mesh_tp(ranks):
    """Phase 40's checks and prints."""
    import torch

    tp = [res["tp"] for res in ranks]
    tp_launches = {}
    for r, tr in enumerate(tp):
        if tr["state_bytes"] != tr["plan_bytes"] or tr["state_bytes_after"] != tr["plan_bytes"]:
            fail(f"tensor-parallel rank {r}: state bytes {tr['state_bytes']} / "
                 f"{tr['state_bytes_after']} != the plan's {tr['plan_bytes']}")
        for k, v in tr["launches"].items():
            tp_launches[k] = tp_launches.get(k, 0) + v
        for name in ("fused_adamw4", "rank1_new_stats"):
            if tr["launches"][name] != 4 * TP_STEPS:
                fail(f"tensor-parallel rank {r}: {name} launched {tr['launches'][name]} times, "
                     f"expected {4 * TP_STEPS} (4 leaves a step on the rank's tiles)")
        if tr["launches"]["quantize_blockwise_4bit"] or tr["launches"]["dequantize_blockwise_4bit"]:
            fail(f"tensor-parallel rank {r}: the training path launched the q4 kernels")
        losses = [s["loss"] for s in tr["steps"]]
        for a, b in zip(losses, EXPECTED_LOSSES):
            if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
                fail(f"tensor-parallel rank {r}: losses {losses} not within 1e-4 relative of "
                     f"phase 6's {EXPECTED_LOSSES[:TP_STEPS]}")
    if [s["loss"] for s in tp[0]["steps"]] != [s["loss"] for s in tp[1]["steps"]]:
        fail(f"tensor-parallel: the ranks' losses differ: {[s['loss'] for s in tp[0]['steps']]} "
             f"and {[s['loss'] for s in tp[1]['steps']]}")
    cell = _tp_reckoned()
    reckoned = cell["collectives"]["result_bytes"]
    recorded = [s["collective_bytes"] for tr in tp for s in tr["steps"]]
    if any(b != reckoned for b in recorded):
        fail(f"tensor-parallel: the steps moved {recorded} B, the reckoning {reckoned} B")
    for r, tr in enumerate(tp):
        for s in tr["steps"]:
            coll = s["collective_fwd_bwd_s"] + s["collective_update_s"]
            print(f"tensor-parallel rank {r} step {s['step']}: loss {s['loss']!r}  "
                  f"{s['ms']:.1f} ms (compute "
                  f"{1e3 * (s['fwd_bwd_s'] - s['collective_fwd_bwd_s']):.1f}, collective "
                  f"{1e3 * coll:.1f}, update {1e3 * (s['update_s'] - s['collective_update_s']):.1f}"
                  f" ms; {s['collective_bytes']:,} B through the collectives)")
        print(f"tensor-parallel rank {r}: {tr['split']} leaves split over model, "
              f"{tr['gathered']} gathered whole; state_bytes {tr['state_bytes']:,} (the plan's "
              f"{tr['plan_bytes']:,}), param_bytes {tr['param_bytes']:,}, peak "
              f"{tr['peak_bytes']:,} B ({tr['peak_bytes'] / 1e9:.2f} GB), launches "
              f"{tr['launches']}")
    print(f"tensor-parallel (1, 2): both ranks' losses bit-equal; collectives {reckoned:,} B a "
          f"step a rank, equal to MeshStep.reckon's (before the split: "
          f"{TP_RECKON_BEFORE:,} B, {reckoned / TP_RECKON_BEFORE:.1%} of it); compute_split "
          f"{cell['compute_split']}")
    partial = _partial_times(torch.device("cuda", 0))
    print("row-parallel partial products of a (1, 2) rank, median of 21: " + ", ".join(
        f"{k} {v:.4f}" for k, v in partial.items()))
    return {"launches": tp_launches, "reckoned": reckoned, "recorded": recorded,
            "link": cell["collectives"], "reckoned_before": TP_RECKON_BEFORE,
            "partial_ms": partial}


def _check_mesh_optim(ranks, new_optimizers):
    """Phase 39's checks and prints: each rule's state bytes a rank against
    its plan, its losses on both ranks against phase 11's, no launch."""
    runs = {}
    for name, lr in NEW_OPTIMIZERS:
        what = f"mesh 2x1 {name} lr {lr:g} ({SHAMPOO_LAYERS} of 24 layers)"
        plan = _plan_rank_bytes(name, SHAMPOO_LAYERS)
        if plan != [MESH_OPTIM_RANK_BYTES[name]] * len(plan):
            fail(f"{what}: the plan gives {plan} B a rank, the prediction "
                 f"{MESH_OPTIM_RANK_BYTES[name]:,}")
        rs = [r["optim"][name] for r in ranks]
        losses = [s["loss"] for s in rs[0]["steps"]]
        want = new_optimizers[name]["losses"]
        if len(losses) != NEW_STEPS or len(want) != NEW_STEPS or not all(
                math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b) for a, b in zip(losses, want)):
            fail(f"{what}: losses {losses} not within 1e-4 relative of phase 11's {want}")
        for r, res in enumerate(rs):
            if [s["loss"] for s in res["steps"]] != losses:
                fail(f"{what}: rank {r}'s losses differ from rank 0's")
            if res["state_bytes"] != plan[r]:
                fail(f"{what}: rank {r} holds {res['state_bytes']:,} B of state, its plan "
                     f"{plan[r]:,}")
            if any(res["launches"].values()):
                fail(f"{what}: rank {r} launched a kernel no route of it has: {res['launches']}")
        for s in rs[0]["steps"]:
            coll = s["collective_fwd_bwd_s"] + s["collective_update_s"]
            print(f"{what} step {s['step']}: loss {s['loss']:.4f} (phase 11: "
                  f"{want[s['step']]:.4f})  {s['ms']:.1f} ms (compute "
                  f"{1e3 * (s['fwd_bwd_s'] - s['collective_fwd_bwd_s']):.1f}, collective "
                  f"{1e3 * coll:.1f}, update {1e3 * (s['update_s'] - s['collective_update_s']):.1f}"
                  f" ms; {s['collective_bytes'] / 1e9:.2f} GB through the collectives)")
        for r, res in enumerate(rs):
            e0 = res["eigh"][0]
            print(f"{what} rank {r}: state_bytes {res['state_bytes']:,} (the plan's), "
                  f"peak {res['peak_bytes']:,} B ({res['peak_bytes'] / 1e9:.2f} GB), "
                  f"{res['seconds']:.1f} s"
                  + (f"; recompute step: {e0['blocks']:,} eigh matrices in {e0['s']:.2f} s "
                     f"({e0['calls']} batched calls)" if e0["blocks"] else ""))
        runs[name] = {"lr": lr, "losses": losses, "phase11_losses": want,
                      "steps": rs[0]["steps"],
                      "ranks": [{k: res[k] for k in ("state_bytes", "peak_bytes", "eigh",
                                                     "seconds")} for res in rs]}
    return {"runs": runs, "seconds": max(r["seconds"]["optim"] for r in ranks)}


def _check_mesh_recurrent(ranks, oracle, oracle_seconds):
    """Phase 43's checks and prints: each arch's losses equal on both ranks
    and within ``RECURRENT_MESH_RTOL`` of the oracle's, state bytes equal
    to the plan, the recorded collective bytes equal to the reckoning and
    to the prediction, B1's launches equal to the oracle's, the gathered
    layer equal to the prediction."""
    launches, out = {}, {"oracle": oracle, "archs": {}}
    for arch, layers in RECURRENT_MESH:
        one = [s["loss"] for s in oracle[arch]["steps"]]
        rs = [r["recurrent"][arch] for r in ranks]
        name = f"{arch}{'' if layers is None else f' ({layers} layers)'}"
        print(f"recurrent mesh oracle (one process, {name}, {RECURRENT_MESH_BATCH} x "
              f"{RECURRENT_MESH_SEQ}): losses {one}, steps "
              f"{[round(s['ms'], 1) for s in oracle[arch]['steps']]} ms, peak "
              f"{oracle[arch]['peak_bytes']:,} B, launches {oracle[arch]['launches']}")
        for r, res in enumerate(rs):
            what = f"recurrent mesh {name} {RECURRENT_MESH_LAYOUT} rank {r}"
            if not res["state_bytes"] == res["state_bytes_after"] == res["plan_bytes"]:
                fail(f"{what}: state bytes {res['state_bytes']} / {res['state_bytes_after']} != "
                     f"the plan's {res['plan_bytes']}")
            recorded = [s["collective_bytes"] for s in res["steps"]]
            if any(b != res["reckoned"] for b in recorded) or \
                    res["reckoned"] != RECURRENT_MESH_RECKONED[arch]:
                fail(f"{what}: the steps moved {recorded} B, MeshStep.reckon {res['reckoned']} B, "
                     f"the prediction {RECURRENT_MESH_RECKONED[arch]} B")
            if res["gathered_layer_bytes"] != RECURRENT_MESH_GATHERED[arch]:
                fail(f"{what}: gathered layer {res['gathered_layer_bytes']:,} B, the prediction "
                     f"{RECURRENT_MESH_GATHERED[arch]:,}")
            if res["gathered_top_bytes"] != RECURRENT_MESH_TOP[arch]:
                fail(f"{what}: gathered top-level leaves {res['gathered_top_bytes']:,} B, the "
                     f"prediction {RECURRENT_MESH_TOP[arch]:,}")
            idle = [m for m in RECURRENT_MESH_MODES.get(arch, ()) if res["calls"][m] <= 0]
            if idle:
                fail(f"{what}: the embed-cut modes {idle} never ran ({res['calls']})")
            losses = [s["loss"] for s in res["steps"]]
            if losses != [s["loss"] for s in rs[0]["steps"]]:
                fail(f"{what}: losses {losses} differ from rank 0's")
            for a, b in zip(losses, one):
                if not (math.isfinite(a) and abs(a - b) <= RECURRENT_MESH_RTOL * abs(b)):
                    fail(f"{what}: losses {losses} not within {RECURRENT_MESH_RTOL} relative of "
                         f"the one-process run's {one}")
            for k in ("fused_adamw4", "rank1_new_stats"):
                if res["launches"][k] != oracle[arch]["launches"][k]:
                    fail(f"{what}: {k} launched {res['launches'][k]} times, the one-process "
                         f"run {oracle[arch]['launches'][k]} (every fused leaf, on the rank's "
                         "tiles)")
            if res["launches"]["quantize_blockwise_4bit"] or \
                    res["launches"]["dequantize_blockwise_4bit"]:
                fail(f"{what}: the training path launched the q4 kernels")
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
            for s in res["steps"]:
                coll = s["collective_fwd_bwd_s"] + s["collective_update_s"]
                print(f"{what} step {s['step']}: loss {s['loss']!r}  {s['ms']:.1f} ms (compute "
                      f"{1e3 * (s['fwd_bwd_s'] - s['collective_fwd_bwd_s']):.1f}, collective "
                      f"{1e3 * coll:.1f}, update "
                      f"{1e3 * (s['update_s'] - s['collective_update_s']):.1f} ms; "
                      f"{s['collective_bytes']:,} B through the collectives)")
            before_layer, before_bytes = RECURRENT_MESH_BEFORE[arch]
            fallback = RECURRENT_MESH_FALLBACK_BEFORE.get(arch)
            print(f"{what}: {res['split']} leaves split over model, {res['gathered']} gathered "
                  f"whole; gathered layer {res['gathered_layer_bytes']:,} B (before the split "
                  f"{before_layer:,}"
                  + ("" if fallback is None else f"; before the fallbacks {fallback[0]:,}")
                  + f"), top-level {res['gathered_top_bytes']:,} B; collectives "
                  f"{res['reckoned']:,} B a step (before {before_bytes:,}"
                  + ("" if fallback is None else f"; before the fallbacks {fallback[1]:,}")
                  + f"); state_bytes {res['state_bytes']:,} (the plan's), param_bytes "
                  f"{res['param_bytes']:,}, peak {res['peak_bytes']:,} B "
                  f"({res['peak_bytes'] / 1e9:.2f} GB); launches {res['launches']}; embed-cut "
                  f"mode calls {res['calls']}")
        out["archs"][arch] = rs
    for r in range(len(ranks)):
        peak = max(ranks[r]["recurrent"][arch]["peak_bytes"] for arch, _ in RECURRENT_MESH)
        print(f"recurrent mesh (phase 43) rank {r}: peak {peak:,} B ({peak / 1e9:.2f} GB)")
    out["launches"] = launches
    out["oracle_launches"] = {k: sum(o["launches"][k] for o in oracle.values())
                              for k in next(iter(oracle.values()))["launches"]}
    print(f"recurrent mesh (phase 43): {oracle_seconds:.1f} s for the oracles, "
          f"{max(r['seconds']['recurrent'] for r in ranks):.1f} s in the ranks")
    return out


def _check_mesh_moe(ranks, oracle, tiles, oracle_seconds):
    """Phase 42's checks and prints: each layout's state bytes, collective
    bytes against the reckoning, losses against the one-process oracle and
    across the ranks, the held routing at (2, 1), B1's launches."""
    one = [s["loss"] for s in oracle["steps"]]
    print(f"MoE mesh oracle (one process, {MOE_MESH_ARCH} {MOE_MESH_LAYERS} layers, "
          f"{MOE_MESH_BATCH} x {MOE_MESH_SEQ}): (loss, aux) "
          f"{[(s['loss'], s['aux']) for s in oracle['steps']]}, steps "
          f"{[round(s['ms'], 1) for s in oracle['steps']]} ms, peak {oracle['peak_bytes']:,} B, "
          f"launches {oracle['launches']}")
    launches = {}
    out = {"oracle": oracle, "tiles": tiles, "layouts": {}}
    for layout in MOE_MESH_LAYOUTS:
        name = f"{layout[0]}x{layout[1]}"
        rs = [r["moe"][name] for r in ranks]
        for r, res in enumerate(rs):
            what = f"MoE mesh {name} rank {r}"
            if not res["state_bytes"] == res["state_bytes_after"] == res["plan_bytes"]:
                fail(f"{what}: state bytes {res['state_bytes']} / {res['state_bytes_after']} != "
                     f"the plan's {res['plan_bytes']}")
            recorded = [s["collective_bytes"] for s in res["steps"]]
            if any(b != res["reckoned"] for b in recorded):
                fail(f"{what}: the steps moved {recorded} B, MeshStep.reckon {res['reckoned']} B")
            losses = [s["loss"] for s in res["steps"]]
            if losses != [s["loss"] for s in rs[0]["steps"]]:
                fail(f"{what}: losses {losses} differ from rank 0's")
            for a, b in zip(losses, one):
                if not (math.isfinite(a) and abs(a - b) <= MOE_MESH_RTOL * abs(b)):
                    fail(f"{what}: losses {losses} not within {MOE_MESH_RTOL} relative of the "
                         f"one-process run's {one}")
            for k in ("fused_adamw4", "rank1_new_stats"):
                if not 0 < res["launches"][k] == oracle["launches"][k]:
                    fail(f"{what}: {k} launched {res['launches'][k]} times, the one-process "
                         f"run {oracle['launches'][k]} (every fused leaf, on the rank's tiles)")
            if res["launches"]["quantize_blockwise_4bit"] or \
                    res["launches"]["dequantize_blockwise_4bit"]:
                fail(f"{what}: the training path launched the q4 kernels")
            for k, v in res["launches"].items():
                launches[k] = launches.get(k, 0) + v
            if len(res["parted"]) != oracle["calls"] or (layout[0] > 1) != (res["slots_held"] > 0):
                fail(f"{what}: routing held on {len(res['parted'])} of {oracle['calls']} calls, "
                     f"{res['slots_held']} slots")
            for s in res["steps"]:
                coll = s["collective_fwd_bwd_s"] + s["collective_update_s"]
                print(f"{what} step {s['step']}: loss {s['loss']!r} aux {s['aux']!r}  "
                      f"{s['ms']:.1f} ms (compute "
                      f"{1e3 * (s['fwd_bwd_s'] - s['collective_fwd_bwd_s']):.1f}, collective "
                      f"{1e3 * coll:.1f}, update "
                      f"{1e3 * (s['update_s'] - s['collective_update_s']):.1f} ms; "
                      f"{s['collective_bytes']:,} B through the collectives)")
            print(f"{what}: {len(res['split'])} leaves split over model; gathered layer "
                  f"{res['gathered_layer_bytes']:,} B; state_bytes {res['state_bytes']:,} (the "
                  f"plan's {res['plan_bytes']:,}), param_bytes {res['param_bytes']:,}, peak "
                  f"{res['peak_bytes']:,} B ({res['peak_bytes'] / 1e9:.2f} GB); launches "
                  f"{res['launches']}")
            parted, share = sum(res["parted"]), sum(res["parted"]) / res["assignments"]
            print(f"{what} routing: {parted} of {res['assignments']:,} assignments ({share:.3%}) "
                  f"parted from one process's at near ties and followed (per call "
                  f"{res['parted']}); largest |dlogit| per call "
                  f"{[round(x, 5) for x in res['dlogit']]}"
                  + (f"; {res['slots_held']:,} of the shard's slots equal to one process's"
                     if layout[0] > 1 else ""))
            if max(res["dlogit"]) > MOE_MESH_DLOGIT[layout] or share > MOE_MESH_PARTED[layout]:
                fail(f"{what}: the routing drifted from one process's: largest |dlogit| "
                     f"{max(res['dlogit'])} (bar {MOE_MESH_DLOGIT[layout]}), {share:.3%} of the "
                     f"assignments parted (bar {MOE_MESH_PARTED[layout]:.2%})")
        out["layouts"][name] = rs
    split, model = (out["layouts"][f"{a}x{b}"][0]["gathered_layer_bytes"]
                    for a, b in MOE_MESH_LAYOUTS)
    print(f"MoE mesh: gathered layer {model:,} B a rank at (1, 2) against {split:,} at (2, 1) "
          f"({model / split:.1%}); B1 on the expert tiles of moe/w1 at (1, 2): "
          f"{tiles[0]['tiles_ms']:.4f} ms over the tiles against {tiles[0]['whole_ms']:.4f} ms "
          f"whole; phase 42: {oracle_seconds:.1f} s for the oracle and the tiles, "
          f"{max(r['seconds']['moe'] for r in ranks):.1f} s in the ranks")
    out["launches"] = launches
    return out


def _one_process_manifest():
    """Leaves and structure of a one-process save of the phase-37 state,
    from its shapes alone (meta tensors), and the bytes of its leaves."""
    import numpy as np

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.io import format as ckfmt
    from repro_torch.io.tree import flatten_with_keys, structure_repr
    from repro_torch.kernels import sr
    from repro_torch.launch.train import abstract_train_state

    _, state = abstract_train_state(cut_depth(get_config("internlm2-1.8b"), MESH_CKPT_LAYERS),
                                    make_optimizer("production4bit", 1e-3), key=sr.PRNGKey(0))
    leaves = [{"key": k, "shape": [int(d) for d in getattr(v, "shape", ())],
               "dtype": ckfmt.dtype_name(v)} for k, v in flatten_with_keys(state)]
    nbytes = sum(int(np.prod(m["shape"], dtype=np.int64))
                 * ckfmt.dtype_from_str(m["dtype"]).itemsize for m in leaves)
    return {"leaves": leaves, "structure": structure_repr(state)}, nbytes


def _mesh_ckpt_run(name, args, counters=None):
    """One phase-37 run of the train CLI; (summary, wall seconds)."""
    import gc

    import torch

    from repro_torch.launch import train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if counters is not None:
        _reset(counters)
    t0 = time.perf_counter()
    try:
        out = train.main(args)
    except (Exception, SystemExit) as e:  # a rank's failure, with its traceback
        fail(f"mesh checkpoint run {name}: {e!r}")
    wall = time.perf_counter() - t0
    if counters is not None:  # the one-process run: its launches are this process's
        out["launches"] = _read(counters)
        out.pop("state")
        gc.collect()
        torch.cuda.empty_cache()
    return out, wall


def phase_mesh_checkpoint(counters, one_process):
    """Phase 37: save on a (data=2, model=1) mesh of two processes, resume on
    2x1, 1x2 and in one process, against phase 10's fresh one-process run
    at the same depth (``one_process``)."""
    import os

    from repro_torch.io import format as ckfmt

    d = ROOT / "build" / "ckpt_mesh_smoke"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    shapes, ckpt_bytes = _one_process_manifest()
    free = shutil.disk_usage(d).free
    print(f"mesh checkpoint ({MESH_CKPT_LAYERS} of 24 layers): {free / 1e9:.2f} GB free under "
          f"{d.relative_to(ROOT)}; one save takes {ckpt_bytes:,} B")
    if free < ckpt_bytes:
        fail(f"the disk cannot hold one checkpoint: {free:,} B free, {ckpt_bytes:,} B needed")
    args = MESH_CKPT_ARGS + ["--ckpt-dir", str(d)]
    # A and B report their final states' digests, to compare them
    mesh_args = lambda run, mesh: args + ["--mesh", mesh, "--run-dir",
                                          str(d.parent / f"mesh_ckpt_{run}")] + (
        ["--digests"] if run in ("A", "B") else [])
    t_phase = time.perf_counter()
    runs = {}
    losses_one = one_process["losses_a"]

    # run A: fresh on 2x1, steps 0-2, the save at step 2
    a, runs["A"] = _mesh_ckpt_run("A", mesh_args("A", "2x1"))
    steps = [r["step"] for r in a["steps"]]
    if steps != [0, 1, 2]:
        fail(f"run A ran steps {steps}")
    losses_a = [r["loss"] for r in a["steps"]]
    for x, want in zip(losses_a, losses_one):
        if not (math.isfinite(x) and abs(x - want) <= 1e-4 * abs(want)):
            fail(f"run A: losses {losses_a} not within 1e-4 relative of phase 10's {losses_one}")
    step_d = ckfmt.step_dir(str(d), MESH_CKPT_STEP)
    if ckfmt.latest_step(str(d)) != MESH_CKPT_STEP:
        fail(f"run A: latest complete step {ckfmt.latest_step(str(d))}, "
             f"expected {MESH_CKPT_STEP}")
    manifest = ckfmt.read_manifest(step_d)
    if manifest["num_hosts"] != 2 or not os.path.exists(os.path.join(step_d, ckfmt.COMMIT)):
        fail(f"run A: num_hosts {manifest['num_hosts']} or no COMMIT in {step_d}")
    host_bytes = [os.path.getsize(os.path.join(step_d, ckfmt.shard_file(p))) for p in (0, 1)]
    if sum(host_bytes) != ckpt_bytes:
        fail(f"run A: host files {host_bytes} sum to {sum(host_bytes):,} B, expected "
             f"{ckpt_bytes:,} B")
    mine = {k: manifest[k] for k in ("leaves", "structure")}
    wants = [("the state's shapes", shapes), ("phase 10's save", one_process["manifest"])]
    for what, want in wants:
        if mine != want:
            fail(f"run A: the manifest's leaves or structure differ from {what}")
    for r in a["ranks"]:
        for name in ("fused_adamw4", "rank1_new_stats"):
            if r["launches"][name] != 4 * len(steps):
                fail(f"run A rank {r['rank']}: {name} launched {r['launches'][name]} times, "
                     f"expected {4 * len(steps)}")
        if r["launches"]["quantize_blockwise_4bit"] or r["launches"]["dequantize_blockwise_4bit"]:
            fail(f"run A rank {r['rank']} launched the q4 kernels: {r['launches']}")
    print(f"mesh checkpoint run A (fresh, 2x1): losses {losses_a}; step {MESH_CKPT_STEP} saved "
          f"by 2 processes, host files {host_bytes[0]:,} + {host_bytes[1]:,} = "
          f"{sum(host_bytes):,} B, manifest ({len(manifest['leaves'])} leaves, structure) equal "
          f"to a one-process save's ({', '.join(w for w, _ in wants)}); {runs['A']:.1f} s")

    # run B: the same command resumes on 2x1
    b, runs["B"] = _mesh_ckpt_run("B", mesh_args("B", "2x1"))
    # run C: elastic, on 1x2
    c, runs["C"] = _mesh_ckpt_run("C", mesh_args("C", "1x2"))
    # run D: one process
    dd, runs["D"] = _mesh_ckpt_run("D", args, counters)
    for name, res, ranks in (("B", b, b["ranks"]), ("C", c, c["ranks"]),
                             ("D", dd, [{"rank": 0, "checkpoint": dd["checkpoint"],
                                         "launches": dd["launches"],
                                         "peak_bytes": dd["peak_bytes"]}])):
        if [r["step"] for r in res["steps"]] != [MESH_CKPT_STEP]:
            fail(f"run {name} ran steps {[r['step'] for r in res['steps']]}")
        for r in ranks:
            if r["checkpoint"]["resumed_from"] != MESH_CKPT_STEP:
                fail(f"run {name} rank {r['rank']}: resumed from "
                     f"{r['checkpoint']['resumed_from']}")
            for k in ("fused_adamw4", "rank1_new_stats"):
                if r["launches"][k] != 4:
                    fail(f"run {name} rank {r['rank']}: {k} launched {r['launches'][k]} times, "
                         "expected 4")
    loss_a = losses_a[MESH_CKPT_STEP]
    if b["steps"][0]["loss"] != loss_a:
        fail(f"run B: step-{MESH_CKPT_STEP} loss {b['steps'][0]['loss']!r} differs from run A's "
             f"{loss_a!r}")
    for ra, rb in zip(a["ranks"], b["ranks"]):
        differ = [k for k in ra["digests"] if rb["digests"].get(k) != ra["digests"][k]]
        if differ or set(ra["digests"]) != set(rb["digests"]):
            fail(f"run B rank {rb['rank']}: final state differs from run A's in "
                 f"{len(differ)} leaves: {differ[:5]}")
        if rb["peak_bytes"] > ra["peak_bytes"]:
            fail(f"run B rank {rb['rank']}: peak {rb['peak_bytes']:,} B above run A's "
                 f"{ra['peak_bytes']:,} B")
    for name, res in (("C", c), ("D", dd)):
        x = res["steps"][0]["loss"]
        if not (math.isfinite(x) and abs(x - loss_a) <= 1e-4 * abs(loss_a)):
            fail(f"run {name}: step-{MESH_CKPT_STEP} loss {x} not within 1e-4 relative of "
                 f"run A's {loss_a}")
    if dd["peak_bytes"] > one_process["peak_bytes_a"]:
        fail(f"run D: peak {dd['peak_bytes']:,} B above phase 10's fresh run "
             f"({one_process['peak_bytes_a']:,} B)")

    report = {"layers": MESH_CKPT_LAYERS, "ckpt_bytes": ckpt_bytes, "host_bytes": host_bytes,
              "losses_a": losses_a, "wall_s": runs, "runs": {}}
    for name, res in (("A", a), ("B", b), ("C", c)):
        rows = []
        for r in res["ranks"]:
            ck = r["checkpoint"]
            saves = ck["saves"]
            rows.append({"rank": r["rank"], "data": r["data"], "model": r["model"],
                         "resumed_from": ck["resumed_from"], "restore_s": ck["restore_s"],
                         "saves": saves, "peak_bytes": r["peak_bytes"],
                         "state_bytes": r["state_bytes"], "launches": r["launches"]})
            save = (f"save() stalled {saves[0]['stall_ms']:.1f} ms, COMMIT after "
                    f"{saves[0]['commit_s']:.2f} s" if saves else "no save")
            restore = (f"restore {ck['restore_s']:.2f} s" if ck["restore_s"] is not None
                       else "fresh")
            fresh = a["ranks"][r["rank"]]["peak_bytes"]
            print(f"mesh checkpoint run {name} rank {r['rank']} (data={r['data']}, "
                  f"model={r['model']}): {restore}; {save}; peak {r['peak_bytes']:,} B "
                  f"({r['peak_bytes'] / 1e9:.2f} GB; run A's rank {fresh / 1e9:.2f} GB); "
                  f"state_bytes {r['state_bytes']:,}")
        steps_ms = [(s["step"], s["loss"], s["ms"]) for s in res["steps"]]
        report["runs"][name] = {"ranks": rows, "steps": steps_ms}
        print(f"mesh checkpoint run {name}: steps (step, loss, ms) {steps_ms}; "
              f"{runs[name]:.1f} s with the processes' start")
    ck = dd["checkpoint"]
    report["runs"]["D"] = {"restore_s": ck["restore_s"], "peak_bytes": dd["peak_bytes"],
                           "steps": [(s["step"], s["loss"], s["ms"]) for s in dd["steps"]],
                           "launches": dd["launches"]}
    print(f"mesh checkpoint run D (one process): restore {ck['restore_s']:.2f} s "
          f"({ckpt_bytes / ck['restore_s'] / 1e9:.2f} GB/s), step "
          f"{MESH_CKPT_STEP} loss {dd['steps'][0]['loss']:.6f} (A {loss_a:.6f}) "
          f"{dd['steps'][0]['ms']:.1f} ms, peak {dd['peak_bytes']:,} B "
          f"({dd['peak_bytes'] / 1e9:.2f} GB); {runs['D']:.1f} s")
    print(f"mesh checkpoint: B bit-equal to A (loss and {len(a['ranks'][0]['digests'])} leaves a "
          f"rank), C {abs(c['steps'][0]['loss'] - loss_a) / loss_a:.2e} and D "
          f"{abs(dd['steps'][0]['loss'] - loss_a) / loss_a:.2e} relative of A")
    report["launches"] = {k: sum(r["launches"][k] for res in (a, b, c) for r in res["ranks"])
                          + dd["launches"][k] for k in dd["launches"]}
    report["seconds"] = time.perf_counter() - t_phase
    print(f"mesh checkpoint phase (37): {report['seconds']:.1f} s")
    shutil.rmtree(d)
    for run in ("A", "B", "C"):
        shutil.rmtree(d.parent / f"mesh_ckpt_{run}", ignore_errors=True)
    return report


# ---------------------------------------------------------------------------
# phase 38 (slice 13): the roofline on the card
# ---------------------------------------------------------------------------


def phase_roofline(card, main_steps, mesh):
    """Phase 38: the dry run's single-pod sweep; the roofline of phase 6's
    step on one rank with the card's constants, against phase 6's median
    step; that count held to one real step on the card under the same
    counters; and phase 35's collective bytes reckoned without a world."""
    import torch

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import adamw4bit, sr
    from repro_torch.launch import dryrun
    from repro_torch.models import init_model
    from repro_torch.roofline.analysis import hw_for_card
    from repro_torch.roofline.measured import Counter, _optimizer, measure
    from repro_torch.train.train_loop import build_train_step, make_train_state

    t_start = time.perf_counter()
    name = card.split(",")[0].strip()
    try:
        hw = hw_for_card(name)
    except ValueError as e:
        fail(f"roofline: {e}")
    # (a) the dry run's cells of DRYRUN_ARCHS on both production plans
    out = OUT_DIR / "dryrun.json"
    OUT_DIR.mkdir(exist_ok=True)
    out.unlink(missing_ok=True)
    t0 = time.perf_counter()
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        records = dryrun.run_all(str(out), archs=DRYRUN_ARCHS)
    sweep_s = time.perf_counter() - t0
    status = {}
    for r in records:
        status[r["status"]] = status.get(r["status"], 0) + 1
    bad = [(r["arch"], r["shape"], r.get("error")) for r in records if r["status"] == "error"]
    if bad:
        fail(f"dry run: {len(bad)} cells in error: {bad}")
    print(f"dry run of {', '.join(DRYRUN_ARCHS)} on both production plans: {len(records)} "
          f"records {status} in {sweep_s:.1f} s")
    # (b) the roofline of phase 6's step: one rank, production4bit with SR
    arch, batch, seq, opt_name = ROOFLINE_ARGS
    cfg = get_config(arch)
    shape = ShapeSpec(f"train_{batch}x{seq}", seq, batch, "train")
    rec = measure(cfg, shape, {"data": 1, "model": 1}, hw, opt_name)
    rf = rec["roofline"]
    step_ms = _median([r["ms"] for r in main_steps[1:]])
    bound_s = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    bound_share = bound_s * 1e3 / step_ms
    mfu = rf["model_flops_total"] / (step_ms * 1e-3 * hw.peak_flops)
    by_dtype = ", ".join(f"{f:,} {d}" for d, f in rec["flops_by_dtype"].items())
    print(f"roofline of phase 6's step ({arch}, {batch} x {seq}, {opt_name}+SR, one rank) on "
          f"{card}: compute {rf['compute_s'] * 1e3:.4f} ms ({rf['flops']:.6e} matmul FLOPs: "
          f"{by_dtype}), "
          f"memory {rf['memory_s'] * 1e3:.4f} ms ({rf['bytes_accessed']:.6e} B), collective "
          f"{rf['collective_s'] * 1e3:.4f} ms; bottleneck {rf['bottleneck']}; model_flops "
          f"{rf['model_flops_total']:.6e}")
    print(f"roofline shares against phase 6's median step {step_ms:.1f} ms (steps 1-4): the "
          f"bound {bound_s * 1e3:.4f} ms is {bound_share:.2%} of it; model_flops / (step x "
          f"peak) = {mfu:.3%}")
    # (c) one real step on the card under the same counters (not a path run)
    dev = torch.device("cuda", 0)
    model = init_model(cfg, seed=0, device=dev)
    opt = _optimizer(opt_name)
    state = make_train_state(model, opt, key=sr.PRNGKey(0))
    step = build_train_step(model, opt)
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq, batch))
    real_batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_at(0).items()}
    torch.cuda.synchronize()
    before = dict(adamw4bit.LAUNCHES)
    with Counter() as c:
        state, metrics = step(state, real_batch)
        loss = float(metrics["loss"])
    torch.cuda.synchronize()
    launched = {k: adamw4bit.LAUNCHES[k] - before[k] for k in before}
    del model, state, step, metrics, real_batch
    torch.cuda.empty_cache()
    rel = abs(c.bytes - rf["bytes_accessed"]) / rf["bytes_accessed"]
    print(f"counted real step on the card: loss {loss:.4f}, {c.flops:,} matmul FLOPs "
          f"{c.flops_by_dtype} (roofline {int(rf['flops']):,} {rec['flops_by_dtype']}), "
          f"{c.bytes:.6e} B (roofline {rf['bytes_accessed']:.6e}, {rel:.3%} apart), B1 passes "
          f"{c.b1}, launches {launched}")
    if c.flops != int(rf["flops"]) or c.flops_by_dtype != rec["flops_by_dtype"]:
        fail(f"roofline: the real step's matmul FLOPs {c.flops_by_dtype} != the count's "
             f"{rec['flops_by_dtype']}")
    if rel > ROOFLINE_BYTES_RTOL:
        fail(f"roofline: the real step's bytes {c.bytes:.6e} are {rel:.2%} from the count's "
             f"{rf['bytes_accessed']:.6e} (bar {ROOFLINE_BYTES_RTOL:.0%})")
    if c.b1 != launched or launched != {"fused_adamw4": 4, "rank1_new_stats": 4}:
        fail(f"roofline: the real step heard B1 passes {c.b1}, launched {launched}, not 4 + 4")
    if not math.isfinite(loss):
        fail(f"roofline: the counted step's loss is {loss}")
    # (d) phase 35's collectives, reckoned from the plan with no world
    cell = measure(cfg, shape, dict(zip(("data", "model"), MESH_SHAPE)), hw, opt_name)
    reckoned = cell["collectives"]["result_bytes"]
    recorded = [s["collective_bytes"] for r in mesh["ranks"] for s in r["train"]["steps"]]
    if any(b != reckoned for b in recorded):
        fail(f"roofline: phase 35 moved {recorded} B a step, the reckoning {reckoned} B")
    print(f"phase 35's collectives reckoned without a world: {reckoned:,} B a step a rank, "
          f"equal to each of its {len(recorded)} recorded steps; link bytes "
          f"{cell['collectives']['total']:.6e} ({cell['collectives']['ops']:.0f} calls)")
    tp = mesh["tp"]
    tp_cell = measure(cfg, shape, dict(zip(("data", "model"), TP_SHAPE)), hw, opt_name)
    if any(b != tp_cell["collectives"]["result_bytes"] for b in tp["recorded"]):
        fail(f"roofline: phase 40 moved {tp['recorded']} B a step, the reckoning "
             f"{tp_cell['collectives']['result_bytes']} B")
    print(f"phase 40's collectives reckoned without a world: "
          f"{tp_cell['collectives']['result_bytes']:,} B a step a rank (before the split "
          f"{TP_RECKON_BEFORE:,} B), equal to each of its {len(tp['recorded'])} recorded steps; "
          f"link bytes {tp_cell['collectives']['total']:.6e} "
          f"({tp_cell['collectives']['ops']:.0f} calls); the rank's compute "
          f"{tp_cell['roofline']['compute_s'] * 1e3:.4f} ms ({tp_cell['compute_split']})")
    seconds = time.perf_counter() - t_start
    print(f"roofline phase (38): {seconds:.1f} s")
    return {"card": card, "dryrun": {"records": len(records), "status": status,
                                     "seconds": sweep_s, "file": str(out.relative_to(ROOT))},
            "roofline": {"record": rec, "step_ms": step_ms, "bound_share": bound_share,
                         "model_flops_share": mfu, "real_step": {
                             "flops": c.flops, "flops_by_dtype": c.flops_by_dtype,
                             "bytes": c.bytes, "bytes_rel_diff": rel,
                             "b1_passes": c.b1, "launches": launched, "loss": loss}},
            "mesh_collectives": {"reckoned": reckoned, "recorded": recorded,
                                 "link": cell["collectives"],
                                 "tp": {"reckoned": tp_cell["collectives"]["result_bytes"],
                                        "recorded": tp["recorded"],
                                        "link": tp_cell["collectives"],
                                        "roofline": tp_cell["roofline"]}},
            "seconds": seconds}


def _plan_rank_bytes(name, layers):
    """Each rank's state bytes of ``name`` under the (data=2, model=1) plan
    at internlm2-1.8b's first ``layers`` layers, from shapes alone."""
    from repro_torch.configs import cut_depth, get_config
    from repro_torch.core.optimizers import make_optimizer
    from repro_torch.models import init_model, named_params, param_axes
    from repro_torch.sharding.specs import mesh_coords, opt_state_shardings, plan_nbytes

    cfg = cut_depth(get_config("internlm2-1.8b"), layers)
    meta = {k: p.detach() for k, p in named_params(init_model(cfg, device="meta")).items()}
    mesh = {"data": MESH_SHAPE[0], "model": MESH_SHAPE[1]}
    state = make_optimizer(name, 1e-3).init(meta)
    plan = opt_state_shardings(state, meta, param_axes(cfg), mesh)
    return [plan_nbytes(state, plan, c, mesh) for c in mesh_coords(mesh)]


def _remat_grads(cfg, batch, dev):
    """One forward+backward of ``cfg`` from seed 0 through the library:
    (loss, every parameter's gradient, the peak bytes from just before the
    loss to just after the backward above what was allocated before the
    model, its ms by CUDA events)."""
    import torch

    from repro_torch.models import init_model, named_params
    from repro_torch.models.model import params_loss

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    params = named_params(init_model(cfg, seed=0, device=dev))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss, _ = params_loss(params, cfg, batch)
    loss.backward()
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    return loss.detach(), {k: p.grad for k, p in params.items()}, peak, start.elapsed_time(end)


def _whole_attention(q, k, v, causal, window, cap):
    """The training attention as one softmax over every key, in the
    inputs' dtype: the oracle of the blockwise version."""
    import torch

    B, S, H, D = q.shape
    G = H // k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.reshape(B, S, -1, G, D), k) / math.sqrt(D)
    if cap > 0:
        s = cap * torch.tanh(s / cap)
    i = torch.arange(S, device=q.device)
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= i[None, :] <= i[:, None]
    if window > 0:
        ok &= i[None, :] > i[:, None] - window
    s = s.masked_fill(~ok[None, :, None, None, :], float("-inf"))
    out = torch.einsum("bqhgk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
    return out.reshape(B, S, H, D)


def _attention_run(fn, q, k, v, w, dev, reps=5):
    """``fn``'s output and q/k/v gradients against the cotangent ``w``, the
    median ms of its forward+backward by CUDA events and its peak bytes
    above what was allocated before it."""
    import torch

    grads, times = None, []
    for _ in range(reps):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*leaves)
        (out * w).sum().backward()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated(dev) - base
        grads = (out.detach(), *(t.grad for t in leaves))
        del out, leaves
    return grads, _median(times), peak


def phase_recompute(dev):
    """Phase 41: (a) internlm2-1.8b at full width and RECOMPUTE_LAYERS of
    its 24 layers, batch 8 x 128, through the library on the card
    (``params_loss`` and its backward): the loss and every parameter's
    gradient with ``remat`` on bit-equal to off (where an op's CUDA
    backward parts two runs, the parted gradients are named and held within
    the gap that two remat-off runs open on the same inputs); the
    forward+backward peak (above what was allocated before the model) and
    ms of each, after a warm-up run, in turns (off, on, on, off). (b) the blockwise training
    attention (``models.attention.train_attention``, the config's 512 /
    1024 chunks) at each RECOMPUTE_ATTN layout, fp32 inputs: its output and
    q/k/v gradients within ATTN_REL of the largest magnitude of a float64
    whole-score softmax's; its forward+backward ms (CUDA events, median of
    5) and peak beside the fp32 whole-score softmax's (the attention the
    port ran before)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.attention import train_attention

    out = {}
    base = get_config("internlm2-1.8b")
    base = dataclasses.replace(base, num_layers=RECOMPUTE_LAYERS,
                               blocks=base.blocks[:RECOMPUTE_LAYERS])
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(DataConfig(base.vocab_size, 128, 8)).batch_at(0).items()}
    _remat_grads(base, batch, dev)  # warm-up: the first products pick their algorithms
    gc.collect()
    # in turns, off, on, on, off, each run's gradients moved to the host before
    # the next, so every run starts from the same allocator state
    runs = {"off": [], "on": []}
    for name in ("off", "on", "on", "off"):
        loss, grads, peak, ms = _remat_grads(dataclasses.replace(base, remat=name == "on"),
                                             batch, dev)
        runs[name].append((loss.cpu(), {k: g.cpu() for k, g in grads.items()}, peak, ms))
        del loss, grads
        gc.collect()
    (l0, g0, p0, _), (l2, g2, _, _) = runs["off"]
    l1, g1, p1, _ = runs["on"][0]
    if not torch.equal(l0, l1) or not torch.equal(l0, l2):
        fail(f"remat: loss {float(l1)!r} with it, {float(l0)!r} / {float(l2)!r} without")
    parted = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    gaps = {}
    for k in parted:  # an op's CUDA backward that parts two runs: the gap of two runs off
        gap = float((g2[k] - g0[k]).abs().max())
        got = float((g1[k] - g0[k]).abs().max())
        gaps[k] = (got, gap)
        if got > gap:
            fail(f"remat: {k}'s gradient {got!r} from remat off, beyond the {gap!r} "
                 f"that two runs without it open")
    ms_off, ms_on = ([r[3] for r in runs[n]] for n in ("off", "on"))
    out["model"] = {"layers": RECOMPUTE_LAYERS, "loss": float(l0), "leaves": len(g0),
                    "parted": gaps, "peak_off": p0, "peak_on": p1, "ms_off": ms_off,
                    "ms_on": ms_on}
    print(f"recompute: internlm2-1.8b at {RECOMPUTE_LAYERS} of 24 layers, 8 x 128: loss "
          f"{float(l0):.6f} and {len(g0) - len(parted)} of {len(g0)} gradients bit-equal with "
          f"remat on and off (parted at an op's CUDA backward, within two runs' gap: "
          f"{gaps or 'none'}); forward+backward peak {p0:,} B off, {p1:,} B on "
          f"({(p0 - p1) / 1e9:.3f} GB less), ms off {ms_off[0]:.1f} / {ms_off[1]:.1f}, on "
          f"{ms_on[0]:.1f} / {ms_on[1]:.1f} (in turns: off, on, on, off)")
    del runs, g0, g1, g2, batch
    gc.collect()
    torch.cuda.empty_cache()

    out["attention"] = []
    for B, S, H, Hkv, D, window, cap in RECOMPUTE_ATTN:
        gen = torch.Generator(device=dev).manual_seed(41)
        q = torch.randn((B, S, H, D), generator=gen, device=dev)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
        v = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
        w = torch.randn((B, S, H, D), generator=gen, device=dev)
        what = (f"train_attention ({B}, {S}, {H} / {Hkv}, {D}) causal"
                + (f", window {window}" if window else "") + (f", softcap {cap:g}" if cap else ""))
        blockwise = lambda a, b, c: train_attention(a, b, c, causal=True, window=window,
                                                    softcap_val=cap)
        whole = lambda a, b, c: _whole_attention(a, b, c, True, window, cap)
        got, ms, peak = _attention_run(blockwise, q, k, v, w, dev)
        _, whole_ms, whole_peak = _attention_run(whole, q, k, v, w, dev)
        want = _attention_run(whole, *(t.double() for t in (q, k, v, w)), dev, reps=1)[0]
        errs = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            scale = float(b.abs().max())
            errs[name] = float((a.double() - b).abs().max()) / scale
            if not errs[name] <= ATTN_REL:
                fail(f"{what}: {name} {errs[name]:.3e} of the largest magnitude from the "
                     f"float64 softmax, above {ATTN_REL:g}")
        rec = {"shape": [B, S, H, Hkv, D], "window": window, "softcap": cap, "rel_err": errs,
               "ms": ms, "peak_bytes": peak, "whole_fp32_ms": whole_ms,
               "whole_fp32_peak_bytes": whole_peak}
        out["attention"].append(rec)
        print(f"recompute: {what}: fwd+bwd {ms:.2f} ms, peak {peak:,} B (the fp32 whole-score "
              f"softmax: {whole_ms:.2f} ms, {whole_peak:,} B); from the float64 softmax "
              + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
        del q, k, v, w, got, want
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main():
    global HBM_BYTES_PER_S, FP32_FLOPS_PER_S
    sys.path.insert(0, str(ROOT / "src"))
    # the caching allocator maps memory in growable segments, so the MoE
    # phases' 7-9 GB gradient stacks do not strand freed blocks (set before
    # CUDA starts; a caller's own setting wins)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    try:
        from repro_torch.kernels import adamw4bit, quant4
        from repro_torch.roofline.analysis import H100
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    HBM_BYTES_PER_S, FP32_FLOPS_PER_S = H100.hbm_bw, H100.fp32_flops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = _LAP[0] = time.perf_counter()

    counters = (adamw4bit.LAUNCHES, quant4.LAUNCHES)
    build_report = phase_build()
    _lap("1 build")
    if sys.argv[1:] == ["--mesh-phases"]:  # phases 10, 34-37, 40, 42 and 43 alone
        checkpoint = phase_checkpoint(counters)
        _lap("10 checkpoint")
        phase_b1_tiles(dev)
        _lap("34 B1 tiles")
        phase_mesh(tuple(p for p in MESH_PARTS if p != "optim"))
        _lap("35-36, 40, 42, 43 mesh")
        phase_mesh_checkpoint(counters, checkpoint)
        _lap("37 mesh checkpoint")
        print(f"chip_smoke: phases 10, 34-37, 40, 42 and 43 passed in "
              f"{time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--moe-mesh-phase"]:  # phase 42 alone
        phase_mesh(("moe",))
        _lap("42 MoE mesh")
        print(f"chip_smoke: phase 42 passed in {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--recurrent-mesh-phase"]:  # phase 43 alone
        phase_mesh(("recurrent",))
        _lap("43 recurrent mesh")
        print(f"chip_smoke: phase 43 passed in {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--mesh-optim-phases"]:  # phases 11 and 39 alone
        new_optimizers = phase_new_optimizers(counters, dev)
        _lap("11 new optimizers")
        phase_mesh(("optim",), new_optimizers)
        _lap("39 mesh optimizers")
        print(f"chip_smoke: phases 11 and 39 passed in {time.perf_counter() - t_start:.1f} s")
        return
    if sys.argv[1:] == ["--recompute-phases"]:  # phases 41 and 6 alone
        phase_recompute(dev)
        _lap("41 recompute")
        phase_main_path(counters)
        _lap("6 main path")
        print(f"chip_smoke: phases 41 and 6 passed in {time.perf_counter() - t_start:.1f} s")
        return
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.split()
    card_info = dict(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                     max_sm_mhz=float(mhz[0]) if mhz else 1980.0)
    print(f"card: {card_info['sms']} SMs, SM clock up to {card_info['max_sm_mhz']:g} MHz, "
          f"now {_sm_clock()}")
    max_err, leaves, per_step = phase_leaves(dev, card_info)
    _lap("2 B1 leaves")
    q4_err, q4_leaves, q4_tree = phase_quant_leaves(dev, card_info, build_report)
    _lap("3 B2/B3 leaves")
    small = phase_small_reference(dev)
    _lap("4 small reference")
    small_serving = phase_small_serving(dev)
    _lap("5 small serving")
    counts, losses, train_peak, main_steps = phase_main_path(counters)
    _lap("6 main path")
    model_ms, opt_ms = phase_profile(dev)
    _lap("7 step profile")
    serving, eng = phase_serve(counters)
    _lap("8 serve path")
    decode_top = phase_serve_profile(eng)
    del eng
    torch.cuda.empty_cache()
    _lap("9 decode profile")
    checkpoint = phase_checkpoint(counters)
    _lap("10 checkpoint")
    new_optimizers = phase_new_optimizers(counters, dev)
    _lap("11 new optimizers")
    small_new = phase_small_new(dev)
    _lap("12 small new optimizers")
    comms = phase_comms(counters, main_steps, train_peak)
    _lap("13 int4 comms")
    arch_leaves, arch_b1 = phase_arch_leaves(dev, card_info)
    _lap("14 arch leaves")
    arch_train = phase_arch_train(counters)
    _lap("15 arch train")
    arch_small = phase_arch_small(dev)
    _lap("16 arch small")
    arch_serve = phase_arch_serve(counters)
    _lap("17 arch serve")
    long_window = phase_long_window(counters, dev)
    _lap("18 long window")
    moe_leaves, moe_b1 = phase_arch_leaves(dev, card_info, MOE_LEAF_SHAPES)
    _lap("19 MoE leaves")
    q4_big = phase_q4_big(dev)
    _lap("20 q4 big leaf")
    moe_train = phase_arch_train(counters, MOE_TRAIN)
    _lap("21 MoE train")
    moe_small = phase_arch_small(dev, tuple(MOE_TRAIN))
    _lap("22 MoE small")
    moe_serve = phase_arch_serve(counters, MOE_SERVE)
    _lap("23 MoE serve")
    rec_leaves, rec_b1 = phase_arch_leaves(dev, card_info, XLSTM_LEAF_SHAPES)
    _lap("24 recurrent leaves")
    rec_train = phase_arch_train(counters, RECURRENT_TRAIN)
    _lap("25 recurrent train")
    rec_small = phase_arch_small(dev, tuple(RECURRENT_TRAIN))
    _lap("26 recurrent small")
    rec_q4_leaves = phase_q4_arch_leaves(dev)
    rec_serve = phase_arch_serve(counters, RECURRENT_SERVE)
    _lap("27 recurrent q4 leaves and serve")
    rec_oracle = phase_prefill_oracle(dev)
    _lap("28 prefill oracle")
    stub_leaves, stub_b1 = phase_arch_leaves(dev, card_info, STUB_LEAF_SHAPES)
    _lap("29 stub leaves")
    stub_train = phase_stub_train(counters, dev)
    _lap("30 stub train")
    stub_small = phase_arch_small(dev, tuple(STUB_TRAIN))
    _lap("31 stub small")
    stub_q4_leaves = phase_q4_arch_leaves(dev, STUB_SERVE)
    stub_serve = phase_stub_serve(counters, dev)
    _lap("32 stub q4 leaves and serve")
    stub_oracle = phase_stub_oracle(dev)
    _lap("33 stub oracle")
    b1_tiles = phase_b1_tiles(dev)
    _lap("34 B1 tiles")
    mesh = phase_mesh(MESH_PARTS, new_optimizers)
    _lap("35-36, 39, 40, 42, 43 mesh")
    mesh_checkpoint = phase_mesh_checkpoint(counters, checkpoint)
    _lap("37 mesh checkpoint")
    roofline = phase_roofline(card, main_steps, mesh)
    _lap("38 roofline")
    recompute = phase_recompute(dev)
    _lap("41 recompute")
    # launches: every path run of the slices, each counted from 0 just before
    # it and read just after (phases 6, 15, 21, 25, 30, 35, 37, 40, 42, 43
    # train; 8, 17, 23, 27, 32 serve)
    path_counts = [counts] + [r["launches"] for t in (arch_train, moe_train, rec_train,
                                                      stub_train)
                              for r in t.values()] + [mesh["launches"],
                                                      mesh["moe"]["launches"],
                                                      mesh["moe"]["oracle"]["launches"],
                                                      mesh_checkpoint["launches"],
                                                      mesh["tp"]["launches"],
                                                      mesh["recurrent"]["launches"],
                                                      mesh["recurrent"]["oracle_launches"]]
    serve_counts = [serving["launches"]] + [r["launches"] for t in (arch_serve, moe_serve,
                                                                    rec_serve, stub_serve)
                                            for r in t.values()]
    launches = {k: sum(c[k] for c in path_counts) for k in ("fused_adamw4", "rank1_new_stats")}
    launches.update({k: sum(c[k] for c in serve_counts)
                     for k in ("quantize_blockwise_4bit", "dequantize_blockwise_4bit")})

    kernels = [{
        "name": "fused_adamw4",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_adamw4.cu",
        "replaces": "src/repro/kernels/adamw4bit.py:233",
        "launches": launches["fused_adamw4"],
        "max_abs_err": max_err,
        # one training step's four launches (wo, w1, w2, w3), SR: the larger
        # of the byte bound and the Threefry integer-ALU bound
        "ms": per_step["sr_ms"],
        "plain_ms": per_step["plain_ms"],
        "bound_ms": per_step["sr_bound_ms"],
        "bound_by": per_step["sr_bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "rank1_new_stats",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fused_adamw4.cu",
        "replaces": "src/repro/kernels/ops.py:181",  # the XLA-fused prepass
        "launches": launches["rank1_new_stats"],
        "max_abs_err": per_step["stats_max_abs_err"],
        # one training step's four launches; plain = the torch prepass
        "ms": per_step["stats_ms"],
        "plain_ms": per_step["prepass_ms"],
        "bound_ms": per_step["stats_bound_ms"],
        "bound_by": per_step["stats_bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "quantize_blockwise_4bit",
        "route": "cuda",
        "source": "src/repro_torch/csrc/quant4.cu",
        "replaces": "src/repro/kernels/quant4.py:47",
        "launches": launches["quantize_blockwise_4bit"],
        "max_abs_err": q4_err["q"],  # scales; codes bit-equal
        # the whole q4 tree of internlm2-1.8b (11 launches, one prepare_params),
        # one launch per event pair (back to back: chip_smoke.json)
        "ms": q4_tree["q_ms"],
        "plain_ms": q4_tree["q_plain_ms"],
        "bound_ms": q4_tree["q_bound_ms"],
        "bound_by": q4_tree["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
    }, {
        "name": "dequantize_blockwise_4bit",
        "route": "cuda",
        "source": "src/repro_torch/csrc/quant4.cu",
        "replaces": "src/repro/kernels/quant4.py:79",
        "launches": launches["dequantize_blockwise_4bit"],
        "max_abs_err": q4_err["dq"],
        # the whole q4 tree (11 launches, one materialize)
        "ms": q4_tree["dq_ms"],
        "plain_ms": q4_tree["dq_plain_ms"],
        "bound_ms": q4_tree["dq_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,  # no single PyTorch call computes this function
    }]
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "card_info": card_info, "build": build_report, "kernels": kernels,
         "leaves": leaves, "per_step": per_step, "train_peak_bytes": train_peak,
         "q4_leaves": q4_leaves, "q4_tree": q4_tree, "small_reference": small,
         "small_serving": small_serving, "losses": losses,
         "step_split_ms": {"model": model_ms, "optimizer": opt_ms}, "serving": serving,
         "decode_chunk_top_kernels": decode_top, "checkpoint": checkpoint,
         "new_optimizers": new_optimizers, "small_new": small_new, "comms": comms,
         "arch_leaves": arch_leaves, "arch_b1_per_step": arch_b1,
         "arch_train": {a: {k: v for k, v in r.items() if k != "split"}
                        for a, r in arch_train.items()},
         "arch_train_split": {a: r["split"] for a, r in arch_train.items()},
         "arch_small": arch_small, "arch_serve": arch_serve, "long_window": long_window,
         "moe_leaves": moe_leaves, "moe_b1_per_step": moe_b1, "q4_big": q4_big,
         "moe_train": {a: {k: v for k, v in r.items() if k != "split"}
                       for a, r in moe_train.items()},
         "moe_train_split": {a: r["split"] for a, r in moe_train.items()},
         "moe_small": moe_small, "moe_serve": moe_serve, "recurrent_leaves": rec_leaves,
         "recurrent_b1_per_step": rec_b1,
         "recurrent_train": {a: {k: v for k, v in r.items() if k != "split"}
                             for a, r in rec_train.items()},
         "recurrent_train_split": {a: r["split"] for a, r in rec_train.items()},
         "recurrent_small": rec_small, "recurrent_q4_leaves": rec_q4_leaves,
         "recurrent_serve": rec_serve,
         "prefill_oracle": rec_oracle, "stub_leaves": stub_leaves,
         "stub_b1_per_step": stub_b1,
         "stub_train": {a: {k: v for k, v in r.items() if k != "split"}
                        for a, r in stub_train.items()},
         "stub_train_split": {a: r["split"] for a, r in stub_train.items()},
         "stub_small": stub_small, "stub_q4_leaves": stub_q4_leaves, "stub_serve": stub_serve,
         "stub_oracle": stub_oracle, "b1_tiles": b1_tiles, "mesh": mesh,
         "mesh_checkpoint": mesh_checkpoint, "roofline": roofline["roofline"],
         "dryrun": roofline["dryrun"], "roofline_mesh_collectives":
             roofline["mesh_collectives"], "roofline_seconds": roofline["seconds"],
         "mesh_optimizers": mesh["optim"], "recompute": recompute, "path_launches": launches,
         "phase_seconds": PHASE_SECONDS, "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
