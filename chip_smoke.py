#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1 and 2, then a JSON
                                           # line of phase 2's numbers

Needs one NVIDIA card (the kernels target Hopper, ``sm_90a``) and
``nvcc``.  Exits non-zero, printing no result, when CUDA is unavailable
or the port is not beside the script.  Phases, each fatal on failure:

1. build every CUDA kernel of the port from the checkout's sources (one
   ``nvcc`` per source, all started together), and read the built code
   with ``cuobjdump --dump-sass``: every flash-attention kernel must run
   on the tensor cores (``HMMA``): the bf16 ones on bf16 products, the
   float32 ones on TF32 products (3xTF32) and the float32
   bf16-accumulate ones on both; the cosine top-k kernels over float32
   keys must be float32 FMA (``FFMA``) with no ``HMMA``, those over bf16
   keys bf16 ``HMMA`` with no TF32 (and no other ``HMMA`` in the
   library); the bf16 decode-attention kernels of the mma path must have
   ``HMMA`` and the others none; the cascade kernels must be ``FFMA``
   with no ``HMMA``; and ``cuobjdump --dump-resource-usage`` must show no
   stack or local memory (no spill) in the decode, cascade, contrastive,
   cosine top-k and flash kernels (every such kernel's registers
   printed);
2. kernel parity, each kernel against its plain torch version on the
   same CUDA tensors, all timed with CUDA events (median of repeats
   after warm-up) over eager calls and over replays of a captured CUDA
   graph (the device's time without the host's launch overhead), with
   the device kernels one call issues read with ``torch.profiler``;
   the PR 15 kernels also at each launch geometry their wrappers choose
   between (cosine top-k's 32- and 64-row key tiles, bf16 flash
   attention's 2- and 4-warp blocks):
   * the cascade lookup at the serving shapes (``TieringConfig``
     defaults: D=768, Q=64, Nh=1024, warm ring 16384, K=64, bucket=256,
     n_probe=8, tail = flush_size * rebuild_every = 256) on a populated
     hot tier and a wrapped warm ring with a real IVF rebuild, several
     tenants, invalid rows and an unindexed tail, fp32 and int8, k in
     {1, 4}; ints and flags equal, scores within ``SCORE_ATOL``;
   * the cosine top-k at Q=64, D=768, N=4096 (the flat cache's
     capacity) and N=65536, 25 % invalid rows, k in {1, 4}, a panel
     ragged across the kernel's tiles (Q=33, N=4099, k up to its
     maximum) and an all-invalid panel; indices equal, scores within
     ``SCORE_ATOL``; and at N=4096 and 65536 the other dtype pairs on
     the same values — bf16 q and keys, float32 q with bf16 keys (both
     the bf16 tensor-core kernel) and bf16 q with float32 keys (widened
     into the float32 kernel) — k in {1, 4}, each timed with its bound
     beside its plain version and the library yardstick, ``torch.topk``
     of the float32 matmul of the widened values (TF32 off); the ragged
     and the all-invalid panels again for both bf16-key pairs;
   * the contrastive forward and backward at B=16 (the paper's batch)
     and B=4096, D=768, on mixed, all-duplicate and all-distinct
     labels; components ``rtol 1e-5``, gradients within ``GRAD_ATOL``
     of torch autograd through the plain version; the forward must be
     one device kernel per call at both batches; timed beside the
     card's launch floor (a one-element in-place add), the backward's
     bound counted both for the rows it must read (the hard pairs) and
     for all rows;
   * the ensemble cascade over E=3 stacked key panels at the cascade's
     serving shapes, random simplex weights per query, several tenants,
     fp32 and int8, k in {1, 4}; ints and flags equal, scores within
     ``SCORE_ATOL``; and at E=1 every output equal to the single
     cascade kernel's;
   * flash attention at Phi-3-mini's prefill (B=8, S=32, H=KV=32,
     hd=96), a long prefill (B=1, S=2048), GQA with a window (H=40,
     KV=8, hd=128, S=1024, W=256), bidirectional (B=64, H=12, hd=64,
     S=32), a ragged prefill (B=3, S=77) and Granite-MoE's prefill
     (B=8, S=32, H=24, KV=8, hd=64); decode attention at Phi-3-mini's
     decode step (B=8, L=64), a ring buffer (B=8, L=4096), GQA (H=40,
     KV=8, hd=128, L=32768), MQA (KV=1) and Granite-MoE's decode step
     (B=8, L=64, H=24, KV=8, hd=64: a group of 3, the row kernel); the
     zoo's prefills (MusicGen B=8, S=288, H=KV=32, hd 64; Pixtral H=32,
     KV=8, hd 128, S=288; Jamba B=8, S=32, H=64, KV=8, hd 128) and decode
     steps (MusicGen and Pixtral L=320 at position 300, Jamba L=64); bf16
     and fp32, outputs within ``ATTN_TOL``, device kernels per call, timed
     beside ``F.scaled_dot_product_attention`` with the same mask (the
     library yardstick, never on the port's path); and, untimed, the
     decode kernel's split edges: a cache of L=30001 (ragged in its
     last split and tile) and a split whose every slot is masked;
   * flash attention's bf16-accumulate mode (``attn_f32=False``) at every
     flash shape in both dtypes and, bf16 only, at the route edges of
     ``FLASH_ACC_BF16_EDGES``: held to its plain version in that mode
     (``ACC_BF16_MAX_REL``, ``ACC_BF16_MEAN_SHARE``), timed beside the
     float32-accumulate kernel on the same inputs (their graph-time
     ratio printed) and with the route the launch takes (one or two
     walks, warps, shared memory; ``tests/torch_flash_routes.py``
     times the routes it does not take);
3. serving: the full-width ``modernbert-149m`` encoder (seeded random
   weights) behind ``CacheService(fused=True)`` and
   ``CachedLLMService(engine=None)``, a 4096-query medical trace in
   batches of 64; the cascade kernel's launch count must equal the plan
   count, with hits, misses and at least one flush + IVF rebuild; the
   final tiers are re-queried fused and four-op, which must agree;
4. training: the same encoder fine-tuned with the paper's recipe
   (``FinetuneConfig()`` defaults: lr 6.5383e-5, batch 16, clip 0.5,
   margin 0.5, one epoch) on the real train split of a 2048-pair
   medical set plus synthetic pairs from 256 unlabeled queries; the
   contrastive forward and backward kernels must each launch once per
   step, every loss and grad norm must be finite, and on the first batch
   the kernels' loss and gradients must equal the plain formulation's;
5. flat serving: the fine-tuned encoder behind the paper's
   ``SemanticCache(capacity=4096)`` over the same trace; the cosine
   top-k kernel's launch count must equal the plan count, with hits and
   misses, ``FLAT_THRESHOLD`` must sit above every score between two
   texts of different meaning, and every answer must be the echo of a
   query of the same meaning;
6. ensemble serving: three full-width panels (the phase-4 fine-tuned
   encoder as the pilot, the untuned seed-0 encoder, a random-projection
   embedder) behind ``CacheService(fused=True, learned_admission=True,
   embedders=3)``, the threshold set in the run above every fused score
   (at the initial uniform weights) between texts of different meaning.
   (a) The same trace through ``CachedLLMService(engine=None)``: the
   ensemble kernel's launch count must equal the plan count, with hits,
   misses, a flush and an IVF rebuild, no hit answered with a query of
   another meaning, and the final tiers must answer the same fused and
   four-op.  (b) A fresh service driven through plan / commit /
   maintenance over the trace on two tenants, each miss answered with
   its meaning's canonical response (a stand-in for an LLM that answers
   paraphrases alike, so misses can be labeled duplicates): at least
   one weight refit and one threshold refit must apply, and launches
   must equal plans; each tenant's learned weights, threshold, hit rate
   and false hits are printed;
7. decoder serving: full-width ``phi3-mini-3.8b`` (32 layers, d_model
   3072, 32 heads of 96, vocab 32064; seeded random weights, float32
   master weights, bf16 activations).  (a) ``ServeEngine`` generates 32
   greedy tokens for 8 prompts of 32 tokens: the flash-attention kernel
   must launch 32 times (one prefill, one per layer) and the
   decode-attention kernel 32 times per decode step; prefill ms, decode
   ms per token and tokens per second are printed.  (c)
   ``CachedLLMService`` with the phase-4 tuned encoder, the tiered
   ``CacheService`` and this engine over a medical trace: generations
   must equal the miss-group leaders, hits never reach the engine, and
   the kernels' launches must equal 32 per prefill and per decode step.
   (d) The same model at ``attn_f32=False``: (a)'s generation with the
   same launches (prefill ms, decode ms, tokens/s beside (a)'s, greedy
   tokens agreeing with (a)'s counted); teacher-forced prefill and decode
   logits through the kernels against the plain versions in that mode
   (10(b)'s bf16 mean and argmax tolerances), beside the plain versions'
   own True-vs-False gap; a 4096-token prefill (B=1, the chunked branch)
   the same way, timed at ``attn_f32=False`` and at ``True`` side by
   side; and a float32 copy cut to 4 layers, held under phase 2's
   bounds for the mode (relative to the logits' scale).
   (b) The same weights with float32 activations, teacher-forced: every
   decode step's logits must equal ``forward_lm``'s at the same position
   within ``DECODE_ATOL`` — the two kernels held against each other at
   full width (it runs after phase 8, once the bf16 decoder is freed);
8. the cache service's maintenance loop, through ``plan`` / ``commit``
   / ``maintenance`` on phase 3's trace and embeddings.  (a) The cold
   tier: hot 256, warm 1024 int8 rows (K=16), a host-RAM cold tier of
   8192 rows, fused: warm-ring overwrites must be captured into the cold
   tier with no drop, with cold fetches, cold hits, a promotion back to
   warm and a cold route rebuild, cascade launches equal to plans and
   every hit answered with the echo of the very same text; the same
   trace four-op must give the same hits, value ids and cold counters.
   (b) Phase 3's configuration with ``background_rebuild`` and
   maintenance on every 32nd batch only, so that flushes race the
   shadow in flight: shadow builds started and published, after every
   batch no warm row newer than the index outside the tail window, every
   hot, tail and listed row answering its own key and every other
   indexed row left out only by a full list, each published shadow equal
   to the inline
   rebuild of its snapshot, and the quiesced tiers equal fused and
   four-op; the plans served during a build and the publish stall are
   printed.  (c) Phase 6(b) again with conformal calibration, every hit
   audited (false iff another meaning): a tenant's floor must rise above
   its learned threshold and launches equal plans; thresholds, floors,
   hit rates and false hits per hit are printed beside 6(b)'s.  (d)
   ``ContinuousBatcher`` over phase 7's decoder (8 slots, a 256-slot
   pool, 32-token prompts, 24 requests of 4 to 32 new tokens) with (b)'s
   ``maintenance`` on idle ticks: every request finishes, flash
   launches equal 32 per admission and decode launches 32 per tick with
   an active slot, the hook runs on idle ticks and skips saturated ones,
   and after every admission the pool's rows equal the slot's prefill
   state bit for bit;
9. the online embedder refresh: the untuned seed-0 full-width encoder
   in an ``EmbedderTrainer`` behind ``CacheService(learned_embedder=True,
   fused=True)`` (phase 3's tiers, the launcher's smoke-scale
   ``EmbedderRefreshPolicy``), phase 3's trace through plan / commit /
   non-blocking ``maintenance()`` for its first 48 batches (refreshes
   train, gate and re-embed on a host thread while serving goes on),
   then a closing join and the last 16 batches under the final
   embedder; misses get their meaning's canonical answer, tenant 1
   (the first two batches) is evicted while the first refresh runs.
   At least one refresh must publish; contrastive forward and backward
   launches must equal the candidates' steps and cascade launches the
   plans; after each publish every valid hot and warm key must equal the
   live encoder's embedding of its text within ``KEY_ATOL``, the
   service's embed function must return the candidate's embeddings, and
   no row evicted during a refresh may be valid.  Refreshes, steps, wall
   times, gate F1, plans served during a refresh, stage p50 with and
   without one, the publish stall, the recalibrated threshold and hit
   rate / false hits per hit by embedder version are printed;
10. the MoE decoder: full-width ``granite-moe-3b-a800m`` (32 layers,
   d_model 1536, 24 heads over 8 KV heads of 64, 40 experts top-8 of
   d_ff 512, vocab 49155; seeded float32 master weights, bf16
   activations), after phase 7's models are freed.  (a) 7(a)'s
   generation: 32 flash launches per prefill and 32 decode launches per
   step; prefill and decode ms, tokens/s, peak memory, the dropped
   assignments per layer at prefill and the weight casts' share of a
   profiled decode step are printed.  (b) Teacher-forced logits through
   the kernels against the same model with the plain attention versions:
   bf16 within ``MOE_BF16_MEAN_TOL`` on the mean and ``MOE_BF16_AGREE``
   on the argmax (router decisions the two paths' roundings flip are
   counted), float32 elementwise within ``DECODE_ATOL``.  (c) 7(c)'s
   1024 requests through ``CachedLLMService`` with this decoder: hits
   and misses must equal 7(c)'s;
11. the rest of the decoder zoo at published widths, one model at a
   time (each freed, and the peak-memory counter reset, before the
   next), after phase 10's model is freed; for each: peak memory,
   prefill ms, decode ms a step, tokens/s, the device kernels of one
   profiled decode step, and flash / decode launches, which must equal
   the prefills and the steps times the attention layers.  (a)
   ``xlstm-125m`` (12 layers alternating mLSTM and sLSTM, d 768, 4 heads,
   vocab 50304, tied embeddings; no attention, so no attention launch)
   through 7(a)'s generation.  (c) 7(c)'s 1024 requests with this
   decoder answering the misses: hits / misses must equal 7(c)'s and
   cascade launches the plans.  (d) ``jamba-1.5-large-398b`` cut to the
   first five positions of its period (four Mamba layers of d_in 16384,
   N 16, dt rank 512; one attention layer without RoPE, 64 heads over 8
   KV heads of 128; two MoE layers of 16 experts top-2 at d_ff 24576;
   bf16 parameters, the config's own), 7(a)'s generation, with the MoE
   layers' dropped assignments.  (e) ``musicgen-large`` (48 layers, d
   2048, MHA 32 x 64, vocab 2048, sinusoidal positions) and (f)
   ``pixtral-12b`` (40 layers, d 5120, 32 heads over 8 KV heads of 128,
   vocab 131072), each generating from 256 frontend-stub frames plus the
   32-token prompts (``use_frontend=True``).  (b) For (a), (d), (e) and
   (f), after each one's generation: the same seed's model with float32
   activations (Jamba's MoE at a capacity factor of experts / top-k, so
   that no assignment drops), teacher-forced decode against
   ``forward_lm`` at every position after a 32-token prompt (behind the
   frontend frames), within ``DECODE_ATOL`` with equal argmax;
12. decoder training, after phase 11's models are freed.  (a) Full-width
   ``phi3-mini-3.8b`` (float32 master weights and Adam moments, bf16
   activations, ``remat`` on) through ``launch/train.py``'s loop for
   ``TRAIN_STEPS`` steps at B=1, S=4096 (``train_4k``'s sequence; its
   global batch cut to 1): each step's loss, grad norm, lr and ms, the
   tokens per second and the peak device memory; every loss and grad
   norm finite, no attention kernel launched (training attention is
   plain torch under autograd), every parameter's gradient present and
   nonzero (each layer's ``attn.wq`` / ``wk`` / ``wv`` among them); then
   3 steps at constant lr 1e-4 on one fixed batch, the last profiled
   (device idle share), whose loss must fall.  (b) On (a)'s model, layer
   0's flash kernel output at S=4096 against the plain chunked training
   attention on the same q, k, v within ``ATTN_TOL``, and
   ``lm_loss``'s NLL (the plain chunked attention) against the NLL of
   ``forward_lm``'s logits (the flash kernel) within ``TRAIN_BF16_ATOL``,
   and a float32 copy cut to 4 layers (the same two checks) within
   ``TRAIN_FP32_RTOL`` relative.  (c) Full-width
   ``granite-moe-3b-a800m``, 3 steps at B=1, S=1024: aux finite and
   > 0, every router's gradient nonzero.  (d)
   ``xlstm-125m``, 2 steps at B=2, S=256 (the recurrent token loops
   under autograd);
13. the sharded warm tier (DESIGN.md §8), after phase 12.  (a) The
   stacked form in this process: phase 2's hot tier and queries, its
   16384 warm rows round-robin over ``SHARDS`` = 4 rings of 4096 rows
   with 16 local clusters each (bucket 256, n_probe 8, tail 256 per
   shard), fp32 and int8: every shard's cascade and E=3 ensemble kernel
   against ``ref.py`` (ints exactly, scores within ``SCORE_ATOL``), the
   stacked lookup must launch S kernels per plan; then, with every row
   indexed, the sharded full probe (n_probe = local clusters) must equal
   one ring of the same rows and lists probed in full (cascade and
   ensemble, fp32, k 1 and 4: ids, slots, flags exactly).  (b)
   ``MESH_RANKS`` = 2 processes on this card over a gloo group (a
   ``FileStore``): each rank's mesh lookup (cascade and ensemble, fp32
   and int8) must equal the S=2 stacked oracle built here bit for bit,
   with one launch per rank per plan.  (c) On those ranks
   ``CacheService(mesh=make_cache_mesh(2))`` over phase 3's trace (its
   keys, threshold 0.999): every hit answered with its own text,
   launches equal to plans on each rank, ``warm_shards == 2``, every
   rank the same hits; hit rate and plan / commit p50 printed beside the
   unsharded service's run of the same trace here.  A rank that fails or
   does not report in time fails the phase;
14. the launch layer's dry-run, after phase 13.  (a) ``python -m
   repro_torch.launch.dryrun`` for each of ``DRYRUN_PAIRS`` — the cache
   program (``langcache``, ``langcache-shardmap``) and Phi-3-mini's
   train_4k, prefill_32k and decode_32k on the production 16x16 mesh,
   the shardmap cache program on the 2x16x16 multi-pod mesh (``pod``
   must shard an argument), Phi-3-mini's train_4k with the activation
   anchors, the cache program at one rank, the 16x16 shardmap
   cache program again (its counts, temp included, must repeat exactly),
   and Phi-3-mini's prefill_32k and decode_32k with ``--attn-bf16``
   (decode's counts must equal the flag-less run's, and prefill must
   move fewer bytes; its bytes and temp are printed beside the
   flag-less run's), and the recurrent decoders' train_4k and
   prefill_32k, xLSTM-125M's whole and Jamba's by ``--extrapolate``
   (1- and 2-period runs scaled to its 9 periods), whose token loops
   the dry-run counts (``localcost.CountedScan``: each run must count
   at least one) — each in a process of its own on a fake process
   group (no data, no transfers), all started together, beside
   ``localcost.local_count_check`` (the local flops of three sharded
   products must equal their counts by hand) and
   ``dryrun.loop_count_check`` for the mLSTM, the sLSTM and Mamba (one
   reduced layer each, train and prefill at ``LOOP_CHECK_TOKENS``: the
   counted loops' counts, temp and collectives must equal the real
   loops' on this host's torch release); every run must end with
   exit code 0 within ``DRYRUN_TIMEOUT_S``, count work and, on more
   than one rank, collectives, and fall back only on the known gaps of
   ``DTensor``'s strategies; per pair the per-device memory, flops,
   bytes, collective bytes, H100 roofline terms and fallbacks are
   printed.  (b) The cache program at one rank for real: the full-width
   encoder on 1024 queries of 64 tokens (the reference's
   ``CACHE_SHAPE``), then ``store.query`` over 1,048,576 float32 keys
   through the cosine top-k kernel (held first to its plain version at
   this shape); its arguments must hold the one-rank dry-run's argument
   bytes exactly and the kernel must launch once per run; its median
   time over ``CACHE_RUN_REPS`` runs is set beside the dry-run's
   ``t_bound`` and its peak memory beside the dry-run's estimate.  Then
   the same program over the same keys in bf16 (``build_cache_program(
   keys_dtype=bfloat16)``: float32 queries with bf16 keys, the bf16-key
   kernel held first to its plain version, indices equal and scores
   within ``SCORE_ATOL``), its arguments the port's bf16 program's (the
   float32 run's less N D 2 bytes), one launch of that kernel a run and
   none of the float32 one; its time, ``store.query``'s and the kernel's
   alone (beside its plain version, library call and bound) printed
   beside the float32 run's.

Prints the card's name and power limit, the stage latencies, a JSON
line of phase 12's training numbers, a JSON line of phase 14's dry-run
numbers, a JSON line of per-kernel numbers and, last, ``{"ok": true,
"device": ...}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SCORE_ATOL = 1e-5          # fp32 sums in another order (~1e-7 observed)
GRAD_ATOL = 1e-6           # contrastive gradients, same reason
SHAPES = dict(D=768, Q=64, Nh=1024, cap=16384, K=64, bucket=256,
              n_probe=8, tail=256)
N_REQUESTS = 4096
BATCH = 64
# The encoder is random-init (no published weights in the repo), so its
# scores cannot tell a paraphrase from an unrelated query.  On the card
# (encoder seed 0, this trace) the largest score between two different
# texts is 0.9941 and the smallest between two equal texts 0.999999:
# 0.999 serves exact repeats only, with no false hit (PERF.md).
THRESHOLD = 0.999
# The flat cache's threshold after fine-tuning: above the largest score
# between two texts of different (entity, aspect) that the fine-tuned
# encoder gives on the card (0.999471 on the H100, PERF.md), so that
# every hit is a query of the same meaning; phase 5 fails if the
# measured maximum reaches it.
FLAT_THRESHOLD = 0.9998
FLAT_CAPACITY = 4096       # examples/serve_with_cache.py's flat cache
TOPK_N = (4096, 65536)     # flat-cache capacity; a 201 MB key panel
ENS_E = 3                  # ensemble panels: tuned, untuned, projection
# the ensemble threshold: this much above the largest fused score
# between two texts of different meaning measured in the run (serving
# embeds the trace in the same 64-text batches as the measurement, so
# the keys are the measured ones)
ENS_MARGIN = 1e-4
CONTRASTIVE_B = (16, 4096)  # the paper's batch; a large one
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor cores
# float32 attention's bound: the published dense TF32 rate over 3, the
# cheapest float32-accurate use of the card (3xTF32: three TF32 products
# a product; one TF32 product is not float32-accurate)
TF32X3_FLOPS = 494.7e12 / 3
# attention kernels against their plain versions: fp32 as the reference's
# kernel tests (sums in another order); bf16 outputs round once, at the
# end, on both sides (the reference's bf16 tolerance)
ATTN_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
            "bfloat16": dict(atol=3e-2, rtol=0.0)}
# (name, B, H, KV, S, hd, causal, window)
FLASH_SHAPES = (("phi3 prefill", 8, 32, 32, 32, 96, True, 0),
                ("long prefill", 1, 32, 32, 2048, 96, True, 0),
                ("gqa window", 1, 40, 8, 1024, 128, True, 256),
                ("bidirectional", 64, 12, 12, 32, 64, False, 0),
                ("ragged prefill", 3, 32, 32, 77, 96, True, 0),
                ("granite prefill", 8, 24, 8, 32, 64, True, 0),
                ("musicgen prefill", 8, 32, 32, 288, 64, True, 0),
                ("pixtral prefill", 8, 32, 8, 288, 128, True, 0),
                ("jamba prefill", 8, 64, 8, 32, 128, True, 0),
                ("phi3 chunked prefill", 1, 32, 32, 4096, 96, True, 0))
# the bf16-accumulate mode (attn_f32=False) against its plain version in
# the same mode: both round weights, v and sums to bf16 at the same
# places and differ where a float32 sum order or an exp a few ulps apart
# flips one rounding (one bf16 ulp of an output, <= 2^-8 max|v|; a few
# carried through the chunked accumulator): max |diff| <= 2^-6 max|v|;
# such flips are rare, while the mode itself rounds every weight: mean
# |diff| <= 1/4 of the plain version's own attn_f32 True-vs-False gap
ACC_BF16_MAX_REL = 2.0 ** -6
ACC_BF16_MEAN_SHARE = 0.25
# (name, B, H, KV, S, hd, causal, window): the bf16 mode's route edges,
# bf16 only: the longest one walk (the last 64-row block reaches 192 keys,
# `ONE_WALK_TILES` tiles), two walks over an odd tile count (5: the paired
# statistics step's second tile missing), whole 1024-key chunks at hd
# 128, a ragged last chunk of 77 keys, and a window starting mid-chunk
FLASH_ACC_BF16_EDGES = (("one walk at capacity", 2, 8, 8, 192, 128, True, 0),
                        ("two walks, odd tiles", 2, 8, 4, 300, 96, True, 0),
                        ("chunks at hd 128", 1, 8, 8, 3072, 128, True, 0),
                        ("ragged last chunk", 1, 8, 8, 4096 + 77, 96, True,
                         0),
                        ("window mid-chunk", 1, 8, 4, 4096, 96, True, 1500))
# (name, B, H, KV, L, hd, cur, window): slot t holds the newest position
# p <= cur with p % L == t; the step at position cur sees the filled
# slots inside the window
DECODE_SHAPES = (("phi3 decode", 8, 32, 32, 64, 96, 48, 0),
                 ("phi3 ring", 8, 32, 32, 4096, 96, 5000, 3000),
                 ("gqa long", 1, 40, 8, 32768, 128, 30000, 0),
                 ("mqa", 8, 32, 1, 4096, 96, 3000, 0),
                 ("granite decode", 8, 24, 8, 64, 64, 48, 0),
                 ("musicgen decode", 8, 32, 32, 320, 64, 300, 0),
                 ("pixtral decode", 8, 32, 8, 320, 128, 300, 0),
                 ("jamba decode", 8, 64, 8, 64, 128, 48, 0))
# (name, B, H, KV, L, hd, cur, window, slots all masked): bf16 MQA cuts
# L = 4096 into 16 splits of 256 rows, so slots 256..511 are split 1
DECODE_EDGES = (("gqa ragged", 1, 40, 8, 30001, 128, 29000, 0, None),
                ("mqa masked split", 8, 32, 1, 4096, 96, 3000, 0,
                 (256, 512)))
DECODER = "phi3-mini-3.8b"
GEN_B, GEN_PROMPT, GEN_NEW = 8, 32, 32
LLM_REQUESTS = 1024        # phase 7(c) trace length
LLM_NEW_TOKENS = 16        # CachedLLMService's default answer length
# phase 7(b): float32 decode against forward_lm at full width; logits are
# O(1) and both paths sum in float32 in another order through 32 layers
DECODE_ATOL = 1e-3
# phase 7(d): attn_f32=False on 7(a)'s model; a prompt that takes the
# chunked branch (above 2048 keys), and a float32 copy cut to 4 layers
LONG_PROMPT = 4096
ACC_BF16_FP32_LAYERS = 4
# phase 8(a): the hierarchy squeezed so the warm ring wraps on the trace
# (about 1775 admissions against 256 + 1024 device rows), the cold ring
# large enough to catch every overwrite
COLD_TIERING = dict(hot_capacity=256, warm_capacity=1024, n_clusters=16,
                    cold_capacity=8192)
# phase 8(d): the continuous batcher's pool over the phase-7 decoder
BATCHER = dict(n_slots=8, max_len=256, prompt_len=32)
BATCHER_REQUESTS = 24
# phase 9: the launcher's smoke-scale refresh policy (the reference's
# `launch/serve.py`); refreshes run over the first three quarters of the
# trace, the last quarter is served after the closing join
REFRESH_POLICY = dict(min_pairs=24, min_class=4, refresh_interval=32,
                      synth_domain="medical", synth_min_pairs=128,
                      recalibrate=True)
REFRESH_BATCHES = 48
# a published key against the live encoder's embedding of its text: two
# embeddings of one text in different 64-text batches score >= 0.999999
# on the card (phase 3), so differ by at most ~1.4e-3 in any entry
KEY_ATOL = 2e-3
MOE_DECODER = "granite-moe-3b-a800m"
# phase 10(b), kernels against the plain attention versions.  In bf16
# each path rounds its attention outputs once, at other places, and a
# router near-tie then flips one of a token's 8 experts: a discrete
# change that moves that sequence's later logits by up to ~0.26 (on the
# H100, PERF.md), so bf16 is held on the mean and the argmax, which a
# wrong kernel (mask, scale, head mapping) moves by O(1) on every row;
# float32, where no decision flips, is held elementwise (7(b)'s
# tolerance), over the prefill and the first 8 decode steps
MOE_BF16_MEAN_TOL = 0.05
MOE_BF16_AGREE = 0.9
MOE_FP32_STEPS = 8
# phase 11: the zoo, in the order run; 11(d) keeps the first five
# positions of Jamba's period of 8 (the full 72 layers, 398.6 B bf16
# parameters, do not fit one card)
JAMBA = "jamba-1.5-large-398b"
JAMBA_POSITIONS = 5
ZOO = ("xlstm-125m", JAMBA, "musicgen-large", "pixtral-12b")
# phase 12: decoder training.  (a) train_4k's sequence at a batch of 1
# (its global batch of 256 does not fit one card beside 59.6 GB of
# float32 parameters, grads and Adam moments); (b) the plain training
# attention against the flash kernel: bf16 NLLs within TRAIN_BF16_ATOL
# (each path rounds its bf16 attention at other places), float32 within
# TRAIN_FP32_RTOL (sums in another order); (c) and (d) the MoE and the
# recurrent decoders
TRAIN_B, TRAIN_S, TRAIN_STEPS = 1, 4096, 5
TRAIN_FIXED_STEPS, TRAIN_FIXED_LR = 3, 1e-4
TRAIN_BF16_ATOL = 2e-2
TRAIN_FP32_LAYERS, TRAIN_FP32_RTOL = 4, 1e-4
MOE_TRAIN = dict(batch=1, seq=1024, steps=3)
XLSTM_TRAIN = dict(batch=2, seq=256, steps=2)
# phase 13: the sharded warm tier.  (a) phase 2's 16384 warm rows over
# SHARDS rings in one process; (b, c) MESH_RANKS ranks on the one card
# (gloo: NCCL takes one rank per device), each failing the phase unless
# it reports within MESH_TIMEOUT_S
SHARDS = 4
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
# phase 14: the launch layer's dry-run.  (a) each (arch, shape, flags) on
# a fake process group in a process of its own, all at once (the
# production 16x16 mesh unless the flags say otherwise); (b) the cache
# program at one rank for real, CACHE_RUN_REPS timed runs
DRYRUN_PAIRS = (
    ("langcache", "cache_lookup", ()),
    ("langcache-shardmap", "cache_lookup", ()),
    ("phi3-mini-3.8b", "train_4k", ()),
    ("phi3-mini-3.8b", "prefill_32k", ()),
    ("phi3-mini-3.8b", "decode_32k", ()),
    ("langcache-shardmap", "cache_lookup", ("--multi-pod",)),
    ("phi3-mini-3.8b", "train_4k", ("--constrain-acts", "--tag", "acts")),
    ("langcache", "cache_lookup", ("--mesh", "data=1,model=1", "--tag",
                                   "one")),
    ("langcache-shardmap", "cache_lookup", ("--tag", "again")),
    ("phi3-mini-3.8b", "prefill_32k", ("--attn-bf16", "--tag", "bf16")),
    ("phi3-mini-3.8b", "decode_32k", ("--attn-bf16", "--tag", "bf16")),
    ("xlstm-125m", "train_4k", ()),
    ("xlstm-125m", "prefill_32k", ()),
    # Jamba's whole prefill_32k runs 8064 counted chunk loops, ~250 s on
    # one host core: 1- and 2-period runs scaled to its 9 periods instead
    (JAMBA, "train_4k", ("--extrapolate",)),
    (JAMBA, "prefill_32k", ("--extrapolate",)),
)
# the recurrent decoders, whose token loops the dry-run counts
DRYRUN_LOOP_ARCHS = ("xlstm-125m", JAMBA)
# beside them, `dryrun.loop_count_check` on this host's torch: each mixer
# cut to one reduced layer, train and prefill at LOOP_CHECK_TOKENS, its
# counted loops against its real ones (one process a mixer)
LOOP_CHECK_TOKENS = 64
DRYRUN_TIMEOUT_S = 300
CACHE_RUN_REPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median per-call device time over ``reps`` runs of ``iters``."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def graph_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median per-call device time of ``iters`` calls of ``fn`` captured
    in one CUDA graph and replayed: the device's time alone.  `cuda_ms`
    times eager calls, which for a small kernel is the host's launch
    rate (the wrapper's checks, allocations and ``ctypes`` call)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(out)


def device_kernels(fn, calls: int = 3) -> dict:
    """{device kernel name: [launches, device µs]} per call of ``fn``,
    read with ``torch.profiler`` over ``calls`` calls after two warm-up
    steps of the profiler's schedule (with one, the events of a traced
    call were now and then lost): what a wrapper call issues on the card
    (a wrapper's count adds one per call, however many kernels the call
    issues), and where its device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule
    got = {}
    for _ in range(3):            # a trace now and then comes back empty
        with tprofile(activities=[ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=2, active=calls,
                                        repeat=1)) as prof:
            for _ in range(2 + calls):
                fn()
                torch.cuda.synchronize()
                prof.step()
        got = {e.key[:64]: [round(e.count / calls, 2),
                            round(e.self_device_time_total / calls, 3)]
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        # or with some events lost (a fraction of a launch per call)
        if got and all(v[0] == round(v[0]) for v in got.values()):
            break
    return got


class forced:
    """Within the block, ``module.name(...)`` returns ``value``: times a
    kernel at a launch geometry its wrapper would not pick here, to show
    that the one it picks is the faster."""

    def __init__(self, module, name: str, value):
        self.module, self.name, self.value = module, name, value

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, lambda *a: self.value)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


# ---------------------------------------------------------------------------
# phase 2: kernel parity at serving shapes
# ---------------------------------------------------------------------------

def build_states(dev, seed: int = 0):
    """A populated hot tier, a wrapped warm ring with a rebuilt IVF and
    an unindexed tail, and a query batch — on the card."""
    import torch
    from repro_torch.cache_service import tiers
    s = SHAPES
    D, Nh, cap = s["D"], s["Nh"], s["cap"]
    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    centres = unit(torch.randn(512, D, generator=g, device=dev))

    def rows(n, noise=0.03):
        c = torch.randint(0, 512, (n,), generator=g, device=dev)
        return unit(centres[c] + noise * torch.randn(n, D, generator=g,
                                                     device=dev))

    def tenants(n):
        return torch.randint(0, 4, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    hot = tiers.init_hot(Nh, D, dev)
    hot, _ = tiers.hot_insert_batch(
        hot, rows(Nh), torch.arange(Nh, device=dev, dtype=torch.int32),
        tenants(Nh))
    hot = hot._replace(valid=hot.valid & (torch.rand(
        Nh, generator=g, device=dev) > 0.2))
    warm = tiers.init_warm(cap, D, s["K"], s["bucket"], dev)
    vid = 10_000
    flush = 256

    def append(warm, n):
        nonlocal vid
        dem = tiers.Demoted(
            keys=rows(n), tenants=tenants(n),
            value_ids=torch.arange(vid, vid + n, device=dev,
                                   dtype=torch.int32),
            mask=torch.ones(n, dtype=torch.bool, device=dev))
        vid += n
        return tiers.warm_append(warm, dem)[0]

    for _ in range((cap + 4096) // flush):         # wraps: cursor 4096
        warm = append(warm, flush)
    warm = tiers.warm_rebuild(warm, iters=4, seed=seed)
    warm = append(warm, 200)                        # the unindexed tail
    warm = warm._replace(valid=warm.valid & (torch.rand(
        cap, generator=g, device=dev) > 0.1))
    # queries: paraphrase-like copies of live warm rows (tail rows
    # included) and hot rows, under the row's tenant, plus fresh rows
    Q = s["Q"]
    live_w = torch.nonzero(warm.valid).squeeze(1)
    tail_w = (int(warm.cursor) - 1 - torch.arange(150, device=dev)) % cap
    src_w = torch.cat([live_w[torch.randint(0, len(live_w), (Q // 2 - 8,),
                                            generator=g, device=dev)],
                       tail_w[:8]])
    live_h = torch.nonzero(hot.valid).squeeze(1)
    src_h = live_h[torch.randint(0, len(live_h), (Q // 4,), generator=g,
                                 device=dev)]
    n_new = Q - len(src_w) - len(src_h)
    q = torch.cat([warm.keys[src_w], hot.keys[src_h], rows(n_new)])
    q = unit(q + 0.015 * torch.randn(Q, D, generator=g, device=dev))
    qt = torch.cat([warm.tenants[src_w], hot.tenants[src_h],
                    tenants(n_new)])
    thr = 0.6 + 0.35 * torch.rand(Q, generator=g, device=dev)
    return hot, tiers.requantize(warm), q.contiguous(), qt, thr


def lookup_args(hot, warm, q, qt, thr):
    return (q, qt, thr, hot.keys, hot.valid, hot.tenants, hot.value_ids,
            warm.keys, warm.valid, warm.tenants, warm.value_ids,
            warm.write_seq, warm.centroids, warm.members, warm.cursor,
            warm.indexed_total, warm.keys_q, warm.scales)


def compare(a, b, what: str) -> float:
    """Ints and flags equal, scores within SCORE_ATOL; returns max
    |score difference|."""
    import torch
    names = ("scores", "value_ids", "warm_slots", "hot_slots", "hot_hit",
             "hit")
    err = 0.0
    for name, x, y in zip(names, a, b):
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{what}: {name} {tuple(y.shape)}/{y.dtype} vs plain "
                 f"{tuple(x.shape)}/{x.dtype}")
        if name == "scores":
            if not torch.isfinite(y).all():
                fail(f"{what}: non-finite scores")
            err = float((x - y).abs().max())
            if err > SCORE_ATOL:
                fail(f"{what}: max |score diff| {err:.3g} > {SCORE_ATOL}")
        elif not torch.equal(x, y):
            n = int((x != y).sum())
            fail(f"{what}: {name} differs in {n} entries")
    return err


def work_bound_ms(hot, warm, q, qt, k: int, quantized: bool, E: int = 1):
    """Least time for one lookup on this card, and what bounds it: the
    bytes this run's inputs make the lookup read (each needed row once,
    on each of the E key panels) and write, over HBM bandwidth, vs its
    fp32 dot products over the fp32 rate.  ``q`` is the pilot query
    (routing runs on it alone); E > 1 adds the other panels' query rows
    and the (Q, E) weights."""
    import torch
    from repro_torch.core.topk import topk_stable
    s = SHAPES
    Q, D, tail, bucket = s["Q"], s["D"], s["tail"], s["bucket"]
    cap = warm.valid.shape[0]
    K = warm.members.shape[0]
    hot_ok = hot.valid[None] & (hot.tenants[None] == qt[:, None])
    _, probes = topk_stable(q @ warm.centroids.T, min(s["n_probe"], K))
    cand = warm.members[probes].reshape(Q, -1)
    offs = torch.arange(tail, device=q.device)
    tail_idx = (warm.cursor - 1 - offs) % cap
    tail_cand = torch.where(warm.write_seq[tail_idx] > warm.indexed_total,
                            tail_idx, -1)
    cand = torch.cat([cand, tail_cand[None].expand(Q, tail)], 1).long()
    is_tail = torch.zeros_like(cand, dtype=torch.bool)
    is_tail[:, -tail:] = True
    safe = cand.clamp(0, cap - 1)
    ok = (cand >= 0) & warm.valid[safe] \
        & (warm.tenants[safe] == qt[:, None]) \
        & (is_tail | (warm.write_seq[safe] <= warm.indexed_total))
    row_bytes = (D + 4) if quantized else 4 * D
    n_bytes = (
        Q * (4 * E * D + 8)                               # q, tenant, thr
        + (Q * E * 4 if E > 1 else 0)                     # weights
        + hot.valid.shape[0] * 5                          # valid, tenant
        + E * int(hot_ok.any(0).sum()) * 4 * D            # live hot rows
        + K * 4 * D                                       # centroids
        + int(torch.unique(probes).numel()) * bucket * 4  # probed lists
        + tail * 4                                        # tail write_seq
        + int(torch.unique(cand[cand >= 0]).numel()) * 9  # valid/ten/seq
        + E * int(torch.unique(safe[ok]).numel()) * row_bytes  # scored
        + Q * k * 12 + Q * 6)                             # outputs
    flops = 2 * D * (E * int(hot_ok.sum()) + Q * K + E * int(ok.sum()))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    print(f"  work at E={E} k={k} ({'int8' if quantized else 'fp32'}): "
          f"{n_bytes / 1e6:.3f} MB unique bytes, {flops / 1e6:.1f} MFLOP")
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(dev):
    import torch
    from repro_torch.kernels.cascade_lookup import ops, ref
    hot, warm, q, qt, thr = build_states(dev)
    args = lookup_args(hot, warm, q, qt, thr)
    s = SHAPES
    kw = dict(n_probe=s["n_probe"], tail=s["tail"])
    out = {"max_abs_err": 0.0}
    for quantized in (False, True):
        for k in (1, 4):
            a = ref.cascade_lookup(*args, k=k, quantized=quantized, **kw)
            b = ops.cascade_lookup(*args, k=k, quantized=quantized, **kw)
            torch.cuda.synchronize()
            err = compare(a, b, f"cascade_lookup quantized={quantized} "
                                f"k={k}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            tag = "int8" if quantized else "fp32"
            print(f"  parity {tag} k={k}: ints/flags equal, max |dscore| "
                  f"{err:.3g}; hits {int(b[5].sum())}/{s['Q']} "
                  f"(hot {int(b[4].sum())})")
        tag = "int8_" if quantized else ""

        def kern():
            return ops.cascade_lookup(*args, k=1, quantized=quantized, **kw)
        out[f"{tag}ms"] = cuda_ms(kern)
        out[f"{tag}graph_ms"] = graph_ms(kern)
        out[f"{tag}device_kernels"] = device_kernels(kern)
        out[f"{tag}plain_ms"] = cuda_ms(lambda: ref.cascade_lookup(
            *args, k=1, quantized=quantized, **kw), iters=5)
        out[f"{tag}bound_ms"], out[f"{tag}bound_by"] = work_bound_ms(
            hot, warm, q, qt, 1, quantized)
        print(f"  {tag or 'fp32_'}k=1: kernel {out[f'{tag}ms']:.4f} ms "
              f"(graph {out[f'{tag}graph_ms']:.4f}), plain "
              f"{out[f'{tag}plain_ms']:.4f} ms, bound "
              f"{out[f'{tag}bound_ms']:.4f} ms ({out[f'{tag}bound_by']}); "
              f"device kernels per call {out[f'{tag}device_kernels']}")
    return out


def ensemble_states(dev, hot, warm, q, seed: int = 3):
    """E key panels over phase 2's tiers: panel 0 the base keys (same
    bits), panel e > 0 the same rows under a random linear view (a
    Gaussian D x D map, renormalized: cosines roughly kept, so
    paraphrase queries still find their rows); the queries' E rows
    likewise, and random simplex weights per query."""
    import torch
    from repro_torch.cache_service import tiers
    g = torch.Generator(device=dev).manual_seed(seed)
    D = q.shape[1]
    maps = [torch.randn(D, D, generator=g, device=dev) / D ** 0.5
            for _ in range(ENS_E - 1)]

    def view(x):
        return torch.stack([x] + [tiers._unit(x @ m) for m in maps])

    wk = view(warm.keys)
    q8, sc = tiers.quantize_rows(wk)
    ens = tiers.EnsembleState(hot_keys=view(hot.keys).contiguous(),
                              warm_keys=wk.contiguous(), warm_keys_q=q8,
                              warm_scales=sc)
    w = torch.rand(q.shape[0], ENS_E, generator=g, device=dev) + 0.05
    return ens, view(q).contiguous(), (w / w.sum(1, keepdim=True))


def ensemble_kernel_phase(dev):
    """The ensemble kernel against its plain version at E=3 on the
    serving shapes, E=1 against the single cascade kernel, and the
    times of both versions."""
    import torch
    from repro_torch.cache_service import tiers
    from repro_torch.kernels.cascade_lookup import ops, ref
    hot, warm, q, qt, thr = build_states(dev)
    ens, qe, w = ensemble_states(dev, hot, warm, q)
    args = (qe, w, qt, thr, ens.hot_keys, hot.valid, hot.tenants,
            hot.value_ids, ens.warm_keys, warm.valid, warm.tenants,
            warm.value_ids, warm.write_seq, warm.centroids, warm.members,
            warm.cursor, warm.indexed_total, ens.warm_keys_q,
            ens.warm_scales)
    s = SHAPES
    kw = dict(n_probe=s["n_probe"], tail=s["tail"])
    out = {"max_abs_err": 0.0}
    one = tiers.init_ensemble(1, hot, warm)      # the base keys, same bits
    for quantized in (False, True):
        for k in (1, 4):
            a = ref.ensemble_lookup(*args, k=k, quantized=quantized, **kw)
            b = ops.ensemble_lookup(*args, k=k, quantized=quantized, **kw)
            torch.cuda.synchronize()
            err = compare(a, b, f"ensemble E={ENS_E} quantized={quantized} "
                                f"k={k}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            print(f"  ensemble E={ENS_E} {'int8' if quantized else 'fp32'} "
                  f"k={k}: ints/flags equal, max |dscore| {err:.3g}; hits "
                  f"{int(b[5].sum())}/{s['Q']} (hot {int(b[4].sum())})")
            # E=1 at weight 1 is the single cascade, bit for bit
            e1 = ops.ensemble_lookup(
                q[None], torch.ones(s["Q"], 1, device=dev), *args[2:4],
                one.hot_keys, *args[5:8], one.warm_keys, *args[9:17],
                one.warm_keys_q, one.warm_scales, k=k, quantized=quantized,
                **kw)
            single = ops.cascade_lookup(*lookup_args(hot, warm, q, qt, thr),
                                        k=k, quantized=quantized, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(e1, single)):
                fail(f"ensemble E=1 differs from the single cascade "
                     f"(quantized={quantized}, k={k})")
        tag = "int8_" if quantized else ""

        def kern():
            return ops.ensemble_lookup(*args, k=1, quantized=quantized, **kw)
        out[f"{tag}ms"] = cuda_ms(kern)
        out[f"{tag}graph_ms"] = graph_ms(kern)
        out[f"{tag}device_kernels"] = device_kernels(kern)
        out[f"{tag}plain_ms"] = cuda_ms(lambda: ref.ensemble_lookup(
            *args, k=1, quantized=quantized, **kw), iters=5)
        out[f"{tag}bound_ms"], out[f"{tag}bound_by"] = work_bound_ms(
            hot, warm, q, qt, 1, quantized, E=ENS_E)
        print(f"  ensemble {tag or 'fp32_'}k=1: kernel "
              f"{out[f'{tag}ms']:.4f} ms (graph {out[f'{tag}graph_ms']:.4f})"
              f", plain {out[f'{tag}plain_ms']:.4f} ms, bound "
              f"{out[f'{tag}bound_ms']:.4f} ms ({out[f'{tag}bound_by']}); "
              f"device kernels per call {out[f'{tag}device_kernels']}")
    print("  ensemble E=1: every output equal to the single cascade "
          "kernel's (fp32, int8; k=1, 4)")
    return out


def score_report(embed_fn, stream) -> dict:
    """Scores between the trace's distinct texts under ``embed_fn``: the
    largest between two different texts and between two texts of
    different meaning (entity, aspect), the smallest between two equal
    texts (embedded at different batch positions), and the paraphrase
    (same meaning, other wording) and unrelated-pair quantiles."""
    import numpy as np
    texts = [x.text for x in stream]
    emb = embed_fn(texts)
    uniq = {t: i for i, t in enumerate(texts)}
    first = np.asarray(list(uniq.values()))
    sims = emb[first] @ emb[first].T
    np.fill_diagonal(sims, -1.0)
    idx = np.asarray([uniq[t] for t in texts])
    same = np.einsum("nd,nd->n", emb, emb[idx])
    meaning = np.asarray([hash((stream[i].entity, stream[i].aspect))
                          for i in first])
    iu = np.triu_indices(len(first), 1)
    para = meaning[iu[0]] == meaning[iu[1]]
    out = {"max_different_text": float(sims.max()),
           "min_equal_text": float(same.min()),
           "max_unrelated": float(sims[iu][~para].max())}
    print(f"  score gap: max different-text {out['max_different_text']:.6f}"
          f", min equal-text {out['min_equal_text']:.6f} ({len(uniq)} "
          "distinct texts)")
    for name, v in (("paraphrase", sims[iu][para]),
                    ("unrelated", sims[iu][~para])):
        qs = np.quantile(v, [0.01, 0.5, 0.99])
        print(f"  {name} pairs ({len(v)}): p1 {qs[0]:.4f} median "
              f"{qs[1]:.4f} p99 {qs[2]:.4f} max {v.max():.4f}")
    # what a lower threshold would admit: paraphrase pairs (would-be
    # paraphrase hits) and unrelated pairs (would-be false hits) above it
    print("  pairs above a threshold (paraphrase / unrelated): " + ", ".join(
        f"{t}: {int((sims[iu][para] >= t).sum())} / "
        f"{int((sims[iu][~para] >= t).sum())}"
        for t in (0.95, 0.98, 0.99, 0.995, 0.999)))
    return out


def topk_bound_ms(Q: int, N: int, D: int, k: int, q_elem: int = 4,
                  k_elem: int = 4):
    """Least time for one cosine top-k: queries (``q_elem`` bytes a
    value: 4 float32, 2 bf16), keys (``k_elem``) and the valid mask read
    once and the outputs written once over HBM bandwidth, vs its 2 Q N D
    flops over the cheapest rate that computes the function: both bf16,
    the bf16 tensor cores (a bf16 product is exact in float32, summed in
    float32); one float32 operand, three bf16 products a product (its
    three bf16 terms: 989 / 3 TFLOP/s, the cheapest float32-accurate
    rate); both float32, 3xTF32 (``TF32X3_FLOPS``, as float32
    attention), whatever the kernel runs on."""
    n_bytes = q_elem * Q * D + k_elem * N * D + N + 8 * Q * k
    rate = {4: BF16_FLOPS, 6: BF16_FLOPS / 3}.get(q_elem + k_elem,
                                                  TF32X3_FLOPS)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * Q * N * D / rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


TOPK_PAIRS = (("bf16", "bfloat16", "bfloat16"),
              ("mixed", "float32", "bfloat16"),
              ("bf16q_f32keys", "bfloat16", "float32"))


def topk_phase(dev):
    """The cosine top-k kernels against their plain version at the flat
    cache's shapes, and the times of both and of the two-call library
    reference (matmul + ``torch.topk``, TF32 off): float32 q and keys,
    then the other dtype pairs (bf16 keys: the tensor-core kernel)."""
    import torch
    from repro_torch.kernels.cosine_topk import ops, ref
    g = torch.Generator(device=dev).manual_seed(1)
    Q, D = 64, 768

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    def check(q, keys, valid, k, what):
        a = ref.cosine_topk(q, keys, valid, k)
        b = ops.cosine_topk(q, keys, valid, k)
        torch.cuda.synchronize()
        if b[0].shape != (q.shape[0], k) or not torch.equal(a[1], b[1]):
            fail(f"cosine_topk {what}: indices differ from the plain "
                 "version")
        err = float((a[0] - b[0]).abs().max())
        if err > SCORE_ATOL:
            fail(f"cosine_topk {what}: max |score diff| {err:.3g}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if keys.dtype == torch.bfloat16:
            out["bf16_keys_max_abs_err"] = max(out["bf16_keys_max_abs_err"],
                                               err)
        return err

    def timed(q, keys, valid):
        """Eager and graph ms at k=1 of the kernel, its plain version and
        the library call: ``torch.topk`` of the float32 matmul of the
        widened values (the kernels' function; a bf16 @ bf16 matmul
        would round every score to bf16)."""
        def kern():
            return ops.cosine_topk(q, keys, valid, 1)

        def plain():
            return ref.cosine_topk(q, keys, valid, 1)

        def library():
            return torch.topk(torch.where(valid, q.float() @ keys.float().T,
                                          -1e30), 1)
        bound, by = topk_bound_ms(Q, keys.shape[0], D, 1, q.element_size(),
                                  keys.element_size())
        return dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                    library_ms=cuda_ms(library), bound_ms=bound,
                    bound_by=by, graph_ms=graph_ms(kern),
                    plain_graph_ms=graph_ms(plain, iters=5),
                    library_graph_ms=graph_ms(library))

    out = {"max_abs_err": 0.0, "bf16_keys_max_abs_err": 0.0, "by_n": {},
           **{f"{p}_by_n": {} for p, _, _ in TOPK_PAIRS}}
    for N in TOPK_N:
        keys = unit(torch.randn(N, D, generator=g, device=dev))
        valid = torch.rand(N, generator=g, device=dev) >= 0.25
        src = torch.randint(0, N, (Q // 2,), generator=g, device=dev)
        q = torch.cat([keys[src], torch.randn(Q - Q // 2, D, generator=g,
                                              device=dev)])
        q = unit(q + 0.05 * torch.randn(Q, D, generator=g, device=dev))
        for k in (1, 4):
            check(q, keys, valid, k, f"N={N} k={k}")
        row = timed(q, keys, valid)
        kernel = ops._kernel
        row["key_tile"] = kernel.key_tile(
            Q, N, torch.cuda.get_device_properties(dev).multi_processor_count,
            kernel.query_tile(), kernel.blocks_per_sm(1))
        row["graph_ms_by_key_tile"] = {}
        for kt in kernel.KEY_TILES:
            with forced(kernel, "key_tile", kt):
                row["graph_ms_by_key_tile"][kt] = graph_ms(
                    lambda: ops.cosine_topk(q, keys, valid, 1))
        out["by_n"][N] = row
        print(f"  cosine_topk N={N}: indices equal, max |dscore| "
              f"{out['max_abs_err']:.3g}; k=1 eager: kernel {row['ms']:.4f} "
              f"ms, plain {row['plain_ms']:.4f}, library "
              f"{row['library_ms']:.4f}; graph: kernel "
              f"{row['graph_ms']:.4f}, plain {row['plain_graph_ms']:.4f}, "
              f"library {row['library_graph_ms']:.4f}; bound "
              f"{row['bound_ms']:.4f} ({row['bound_by']}); key tile "
              f"{row['key_tile']} (graph ms by key tile "
              f"{row['graph_ms_by_key_tile']})")
        # the other dtype pairs on the same values, rounded where bf16
        for pair, q_dt, k_dt in TOPK_PAIRS:
            qp, kp = q.to(getattr(torch, q_dt)), keys.to(getattr(torch, k_dt))
            for k in (1, 4):
                check(qp, kp, valid, k, f"{pair} N={N} k={k}")
            out[f"{pair}_by_n"][N] = rp = timed(qp, kp, valid)
            print(f"  cosine_topk {q_dt} q x {k_dt} keys N={N}: indices "
                  f"equal; k=1 graph: kernel {rp['graph_ms']:.4f} ms, plain "
                  f"{rp['plain_graph_ms']:.4f}, library (widened matmul + "
                  f"topk) {rp['library_graph_ms']:.4f}; bound "
                  f"{rp['bound_ms']:.4f} ({rp['bound_by']})")
    # ragged across the kernels' query tiles and key tiles
    keys = unit(torch.randn(4099, D, generator=g, device=dev))
    valid = torch.rand(4099, generator=g, device=dev) >= 0.25
    q33 = unit(keys[-33:] + 0.05 * torch.randn(33, D, generator=g,
                                                device=dev))
    empty = torch.zeros(256, dtype=torch.bool, device=dev)
    for pair, q_dt, k_dt in (("float32", "float32", "float32"),
                             *TOPK_PAIRS[:2]):
        qp = q33.to(getattr(torch, q_dt))
        kp = keys.to(getattr(torch, k_dt))
        for k in (1, ops._kernel.max_k()):
            check(qp, kp, valid, k, f"{pair} Q=33 N=4099 k={k}")
        check(q.to(qp.dtype), kp[:256], empty, 4, f"{pair} all-invalid")
        print(f"  cosine_topk {q_dt} q x {k_dt} keys: Q=33 N=4099 k in (1, "
              f"{ops._kernel.max_k()}) indices equal; all-invalid panel: "
              "indices 0..k-1 as the plain version")
    return out


def contrastive_bound_ms(B: int, D: int, backward: bool, hard=None):
    """Least time: the forward reads e1, e2 and the labels and writes
    the components and the loss (6 B D flops); the backward reads e1 and
    e2 of the ``hard`` pairs (those with a nonzero coefficient; all B
    when None) and the upstream scalar and writes both gradients of
    every pair (6 D flops per hard pair).  Bytes bound both."""
    if backward:
        h = B if hard is None else hard
        n_bytes, flops = 8 * h * D + 8 * B * D + 4, 6 * h * D
    else:
        n_bytes, flops = 8 * B * D + 4 * B + 20, 6 * B * D
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def contrastive_hard_pairs(e1, e2, lab, margin: float = 0.5) -> int:
    """Pairs whose loss coefficient is nonzero (the training loss's hard
    pairs with d != 0, or with d < margin if distinct), from the plain
    formulation: the rows the backward must read."""
    import torch
    from repro_torch.core import losses
    d = losses.cosine_distance(e1, e2)
    pos, neg = lab == 1, lab == 0
    min_neg = torch.where(neg, d, losses.BIG).min()
    max_pos = torch.where(pos, d, -losses.BIG).max()
    hp = pos & torch.where(neg.any(), d > min_neg, True)
    hn = neg & torch.where(pos.any(), d < max_pos, True)
    coef = 2 * d * hp - 2 * (margin - d).clamp_min(0) * hn
    return int((coef != 0).sum())


def launch_floor_ms(dev):
    """(eager, graph) ms of a one-element in-place add: the card's cost
    of one launch that does no work."""
    import torch
    x = torch.zeros(1, device=dev)
    return cuda_ms(lambda: x.add_(1.0)), graph_ms(lambda: x.add_(1.0))


def contrastive_phase(dev):
    """The contrastive forward and backward kernels against the plain
    formulation (its autograd for the gradients) on the same CUDA
    tensors, and the times of both beside the card's launch floor."""
    import torch
    from repro_torch.core import losses
    from repro_torch.kernels.contrastive import kernel, ops, ref
    g = torch.Generator(device=dev).manual_seed(2)
    D = 768
    floor_eager, floor_graph = launch_floor_ms(dev)
    print(f"  launch floor (one-element in-place add): eager "
          f"{floor_eager:.4f} ms, graph {floor_graph:.4f} ms")
    out = {"max_abs_err": 0.0, "by_b": {}, "launch_floor_ms": floor_eager,
           "launch_floor_graph_ms": floor_graph}
    for B in CONTRASTIVE_B:
        for labels in ("mixed", "pos", "neg"):
            e1 = torch.randn(B, D, generator=g, device=dev)
            e2 = 0.6 * e1 + torch.randn(B, D, generator=g, device=dev)
            if labels == "mixed":
                lab = (torch.rand(B, generator=g, device=dev) < 0.5).int()
                lab[0], lab[-1] = 0, 1
            else:
                lab = torch.full((B,), int(labels == "pos"),
                                 dtype=torch.int32, device=dev)
            want = torch.stack(ref.contrastive_components(e1, e2, lab))
            got = torch.stack(ops.contrastive_components(e1, e2, lab))
            a1, a2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
            p_loss = losses.online_contrastive_loss(a1, a2, lab)
            p1, p2 = torch.autograd.grad(p_loss, (a1, a2))
            b1, b2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
            k_loss = ops.online_contrastive_loss(b1, b2, lab)
            k1, k2 = torch.autograd.grad(k_loss, (b1, b2))
            torch.cuda.synchronize()
            what = f"contrastive B={B} {labels}"
            if not torch.allclose(got[:2], want[:2], rtol=1e-5, atol=1e-6) \
                    or not torch.allclose(got[2:], want[2:], rtol=0,
                                          atol=1e-6):
                fail(f"{what}: components {got.tolist()} vs plain "
                     f"{want.tolist()}")
            if not torch.allclose(k_loss, p_loss, rtol=1e-5, atol=0):
                fail(f"{what}: loss {float(k_loss)} vs plain "
                     f"{float(p_loss)}")
            err = max(float((k1 - p1).abs().max()),
                      float((k2 - p2).abs().max()))
            if err > GRAD_ATOL:
                fail(f"{what}: max |dgrad| {err:.3g} > {GRAD_ATOL}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if labels == "mixed":
                mixed = (e1, e2, lab)
        # times at the mixed batch, on the kernels' own entry points; the
        # forward's outputs after the loss are what the backward reads
        a, b, lab = mixed
        saved = kernel.forward(a, b, lab, 0.5)[2:]
        up = torch.ones((), device=dev)

        def kfwd():
            return kernel.forward(a, b, lab, 0.5)

        def kbwd():
            return kernel.backward(a, b, *saved, up)
        fwd, bwd = cuda_ms(kfwd), cuda_ms(kbwd)
        fwd_graph, bwd_graph = graph_ms(kfwd), graph_ms(kbwd)
        fwd_kernels, bwd_kernels = device_kernels(kfwd), device_kernels(kbwd)
        a1, a2 = a.clone().requires_grad_(), b.clone().requires_grad_()
        plain_fwd = cuda_ms(lambda: losses.online_contrastive_loss(
            a1, a2, lab))
        plain_both = cuda_ms(lambda: torch.autograd.grad(
            losses.online_contrastive_loss(a1, a2, lab), (a1, a2)))
        hard = contrastive_hard_pairs(a, b, lab)
        fb, fby = contrastive_bound_ms(B, D, False)
        bb, bby = contrastive_bound_ms(B, D, True, hard)
        bb_all, _ = contrastive_bound_ms(B, D, True)
        out["by_b"][B] = dict(
            fwd_ms=fwd, bwd_ms=bwd, fwd_graph_ms=fwd_graph,
            bwd_graph_ms=bwd_graph, fwd_host_us=1e3 * (fwd - fwd_graph),
            bwd_host_us=1e3 * (bwd - bwd_graph),
            fwd_device_kernels=fwd_kernels,
            bwd_device_kernels=bwd_kernels, plain_fwd_ms=plain_fwd,
            plain_bwd_ms=plain_both - plain_fwd, fwd_bound_ms=fb,
            fwd_bound_by=fby, bwd_bound_ms=bb, bwd_bound_by=bby,
            bwd_bound_all_rows_ms=bb_all, hard_pairs=hard)
        print(f"  contrastive B={B}: components, loss and gradients equal "
              f"the plain version's (max |dgrad| {out['max_abs_err']:.3g});"
              f" forward {fwd:.4f} ms (graph {fwd_graph:.4f}, plain "
              f"{plain_fwd:.4f}, bound {fb:.6f} ({fby})), backward "
              f"{bwd:.4f} ms (graph {bwd_graph:.4f}, plain "
              f"{plain_both - plain_fwd:.4f}, bound {bb:.6f} for the {hard} "
              f"hard of {B} pairs, {bb_all:.6f} reading all rows ({bby})); "
              f"launch floor graph {floor_graph:.4f} ms; device kernels per "
              f"call {fwd_kernels} / {bwd_kernels}")
    return out


def check_contrastive_one_launch(cp) -> None:
    """The forward is one device kernel per call at every batch."""
    for B, row in cp["by_b"].items():
        kernels = row["fwd_device_kernels"]
        if len(kernels) != 1 or next(iter(kernels.values()))[0] != 1:
            fail(f"contrastive forward at B={B}: device kernels per call "
                 f"{kernels}, expected one kernel, launched once")


# ---------------------------------------------------------------------------
# phase 3: serving through the port's entry points
# ---------------------------------------------------------------------------

def serving_phase(dev):
    import numpy as np
    from repro_torch.cache_service import (
        CacheConfig, CacheService, TieringConfig,
    )
    from repro_torch.core import EmbedderTrainer, FinetuneConfig
    from repro_torch.data import HashTokenizer, make_query_stream
    from repro_torch.kernels.cascade_lookup import kernel
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving import CachedLLMService

    cfg = encoder_config()
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    trainer = EmbedderTrainer(cfg, FinetuneConfig(max_len=32, seed=0),
                              device=dev)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    telemetry = Telemetry(tracer=Tracer(keep=N_REQUESTS))
    cache = CacheService(CacheConfig(
        dim=cfg.d_model, threshold=THRESHOLD, telemetry=telemetry,
        tiering=TieringConfig(fused=True)), device=dev)
    svc = CachedLLMService(trainer.make_embed_fn(tok), cache, None, tok)
    stream = make_query_stream("medical", N_REQUESTS, seed=11,
                               repeat_frac=0.4)
    texts = [x.text for x in stream]
    print(f"  encoder {cfg.name}: {n_params:,} params, built in "
          f"{time.perf_counter() - t0:.1f} s")

    kernel.COUNTS["cascade_lookup"] = 0
    t0 = time.perf_counter()
    served = []
    for i in range(0, N_REQUESTS, BATCH):
        served += svc.handle(texts[i:i + BATCH], tenant=0)
    wall = time.perf_counter() - t0
    launches = kernel.COUNTS["cascade_lookup"]

    st = svc.stats()
    bk = st["backend"]
    plans = bk["traffic"]["plans"]
    print(f"  served {len(served)} requests in {wall:.2f} s: hits "
          f"{st['hits']} (hot {bk['traffic']['hot_hits']}, warm "
          f"{bk['traffic']['warm_hits']}), misses {st['misses']}, hit rate "
          f"{st['hit_rate']:.3f}; demotions {bk['tiers']['demotions']}, "
          f"rebuilds {bk['rebuild']['rebuilds']}, warm occupancy "
          f"{bk['tiers']['warm_occupancy']:.4f}")
    if launches != plans:
        fail(f"cascade kernel launched {launches} times for {plans} plans")
    if not (st["hits"] > 0 and st["misses"] > 0):
        fail(f"need hits and misses: {st['hits']} / {st['misses']}")
    if bk["rebuild"]["rebuilds"] < 1 or bk["tiers"]["demotions"] < 1 \
            or bk["tiers"]["warm_occupancy"] <= 0:
        fail("no flush + IVF rebuild happened: the warm ring is unused")
    # the threshold sits in the gap between scores of different texts
    # and of equal texts (embedded at different batch positions), so a
    # hit, and a miss coalesced under its group leader, must be answered
    # with the echo of the very same query text
    sc = score_report(svc.embed_fn, stream)
    if not sc["max_different_text"] < THRESHOLD <= sc["min_equal_text"]:
        fail(f"threshold {THRESHOLD} outside the observed score gap")
    for r in served:
        if r.response != f"answer({r.query})":
            fail(f"request {r.query!r} answered {r.response!r}")

    p50 = stage_p50(telemetry)
    hit_scores = [r.score for r in served if r.cache_hit]
    print(f"  hit scores: min {min(hit_scores):.5f} median "
          f"{statistics.median(hit_scores):.5f}")

    # what came out is right: unit-norm finite keys of the right shape,
    # and the final tiers answer the same through the kernel and the
    # four-op composition
    emb = svc.embed_fn(texts[-BATCH:])
    if emb.shape != (BATCH, cfg.d_model) or not np.isfinite(emb).all() \
            or np.abs(np.linalg.norm(emb, axis=1) - 1).max() > 1e-3:
        fail(f"bad embeddings: {emb.shape}")
    final_tiers_agree(cache, emb, "serving")
    prof = profile(lambda: svc.handle(texts[:BATCH], tenant=0),
                   "serving batch")
    return {"launches": launches, "plans": plans, "p50_ms": p50,
            "hits": st["hits"], "hit_rate": st["hit_rate"], "profile": prof,
            "embed_fn": svc.embed_fn, "texts": texts}


def profile(fn, what: str) -> dict:
    """Where one call's time goes: ``torch.profiler`` over one more
    ``fn()`` (after the counted run), device busy time against the host
    wall clock, and the top operations by device and host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()                                            # warm
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels (device events) only: a host op's device time repeats them
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    idle = 1 - dev_us / 1e3 / (wall * 1e3)
    print(f"  profile of one {what}: host wall {wall * 1e3:.3f} ms, device "
          f"busy {dev_us / 1e3:.3f} ms (idle share {idle:.3f}) over "
          f"{sum(e.count for e in kernels)} kernel launches")
    for key, label, pool in (("self_device_time_total", "device", kernels),
                             ("self_cpu_time_total", "host", events)):
        top = sorted(pool, key=lambda e: getattr(e, key),
                     reverse=True)[:8]
        print(f"  top by {label} time: " + "; ".join(
            f"{e.key[:48]} {getattr(e, key) / 1e3:.3f} ms x{e.count}"
            for e in top))
    return {"wall_ms": wall * 1e3, "device_ms": dev_us / 1e3,
            "idle_share": idle,
            "launches": sum(e.count for e in kernels),
            "kernel_ms": {e.key: e.self_device_time_total / 1e3
                          for e in kernels}}


def stage_p50(telemetry) -> dict:
    stages = {}
    for root in telemetry.tracer.roots():
        for child in root.children:
            stages.setdefault(child.name, []).append(child.duration_s)
    p50 = {n: 1e3 * statistics.median(v) for n, v in stages.items()}
    print("  stage p50 (ms, host wall incl. sync): " + ", ".join(
        f"{n} {p50[n]:.3f}" for n in ("embed", "plan", "generate",
                                      "commit") if n in p50))
    return p50


# ---------------------------------------------------------------------------
# phase 4: fine-tuning with the paper's recipe
# ---------------------------------------------------------------------------

def encoder_config():
    from repro_torch.configs import get_config
    cfg = get_config("modernbert-149m")
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
              cfg.vocab_size, cfg.dtype)
    if widths != (22, 768, 12, 1152, 50368, "bfloat16"):
        fail(f"modernbert-149m is not at its published widths: {widths}")
    return cfg


def training_set():
    """The real train split of a 2048-pair medical set plus the synthetic
    pairs the template generator makes from 256 unlabeled queries (the
    paper's real-plus-synthetic recipe), and the eval split."""
    import numpy as np
    from repro_torch.core import (
        TemplateGenerator, generate_synthetic_pairs, records_to_dataset,
    )
    from repro_torch.data import PairDataset, make_pair_dataset, sample_query
    train, evl = make_pair_dataset("medical", 2048, seed=0).split(
        eval_frac=0.15, seed=1)
    rng = np.random.default_rng(2)
    unlabeled = [sample_query(rng, "medical") for _ in range(256)]
    syn = records_to_dataset(generate_synthetic_pairs(
        unlabeled, TemplateGenerator(seed=1), n_pos=2, n_neg=2))
    full = PairDataset(q1=list(train.q1) + list(syn.q1),
                       q2=list(train.q2) + list(syn.q2),
                       labels=np.concatenate([train.labels, syn.labels]),
                       domain="medical")
    return full, evl, len(train), len(syn)


def first_batch_check(trainer, train, tok):
    """On the first batch of the fit, the kernels' loss and dL/de1,
    dL/de2 against the plain formulation on the same embeddings."""
    import numpy as np
    import torch
    from repro_torch.core import losses
    from repro_torch.data import iter_batches, tokenize_pairs
    from repro_torch.kernels.contrastive import ops
    ft = trainer.ft
    batch = next(iter_batches(tokenize_pairs(train, tok, ft.max_len),
                              ft.batch_size, seed=ft.seed))
    dev = trainer.device
    with torch.no_grad():
        toks = torch.as_tensor(
            np.concatenate([batch["tok1"], batch["tok2"]]), device=dev)
        masks = torch.as_tensor(
            np.concatenate([batch["mask1"], batch["mask2"]]), device=dev)
        e1, e2 = trainer.model.encode(toks, masks).chunk(2)
    lab = torch.as_tensor(batch["label"], device=dev)
    res = []
    for fn in (ops.online_contrastive_loss, losses.online_contrastive_loss):
        a1, a2 = e1.clone().requires_grad_(), e2.clone().requires_grad_()
        loss = fn(a1, a2, lab, ft.margin)
        res.append((loss.detach(), *torch.autograd.grad(loss, (a1, a2))))
    torch.cuda.synchronize()
    (kl, k1, k2), (pl, p1, p2) = res
    err = max(float((k1 - p1).abs().max()), float((k2 - p2).abs().max()))
    if not torch.allclose(kl, pl, rtol=1e-5, atol=0) or err > GRAD_ATOL:
        fail(f"first batch: kernel loss {float(kl)} vs plain {float(pl)}, "
             f"max |dgrad| {err:.3g}")
    print(f"  first batch: kernel loss {float(kl):.6f} = plain "
          f"{float(pl):.6f}, max |dgrad| {err:.3g}")


def training_phase(dev):
    import numpy as np
    import torch
    from repro_torch.core import EmbedderTrainer, FinetuneConfig
    from repro_torch.data import HashTokenizer
    from repro_torch.kernels.contrastive import kernel

    cfg = encoder_config()
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    ft = FinetuneConfig(max_len=32, log_every=1)    # the paper's recipe
    trainer = EmbedderTrainer(cfg, ft, device=dev)
    train, evl, n_real, n_syn = training_set()
    print(f"  train {len(train)} pairs ({n_real} real + {n_syn} synthetic),"
          f" eval {len(evl)}; lr {ft.lr}, batch {ft.batch_size}, clip "
          f"{ft.max_grad_norm}, margin {ft.margin}, {ft.epochs} epoch")
    first_batch_check(trainer, train, tok)
    before = trainer.evaluate(evl, tok)

    for name in kernel.COUNTS:
        kernel.COUNTS[name] = 0
    out = trainer.fit(train, tok)
    launches = dict(kernel.COUNTS)
    steps = out["steps"]

    hist = trainer.history
    losses = np.asarray([h["loss"] for h in hist])
    norms = np.asarray([h["grad_norm"] for h in hist])
    if len(hist) != steps or not (np.isfinite(losses).all()
                                  and np.isfinite(norms).all()):
        fail(f"non-finite loss or grad norm in {len(hist)} logged steps")
    for name, n in launches.items():
        if n != steps:
            fail(f"{name} launched {n} times in {steps} steps")
    step_ms = 1e3 * np.diff([0.0] + [h["seconds"] for h in hist])
    after = trainer.evaluate(evl, tok)
    print(f"  {steps} steps in {out['train_seconds']:.2f} s; step p50 "
          f"{np.median(step_ms):.3f} ms (host wall incl. one sync), loss "
          f"{losses[:10].mean():.4f} (first 10) -> {losses[-10:].mean():.4f}"
          f" (last 10), grad norm p50 {np.median(norms):.4f}")
    for tag, m in (("before", before), ("after", after)):
        print(f"  eval {tag}: precision {m['precision']:.4f} recall "
              f"{m['recall']:.4f} f1 {m['f1']:.4f} ap {m['ap']:.4f}")
    from repro_torch.data import iter_batches, tokenize_pairs
    batch = next(iter_batches(tokenize_pairs(train, tok, ft.max_len),
                              ft.batch_size, seed=5))
    prof = profile(lambda: trainer._step(batch), "training step")
    return {"trainer": trainer, "tok": tok, "steps": steps,
            "launches": launches, "step_p50_ms": float(np.median(step_ms)),
            "before": before, "after": after, "profile": prof}


# ---------------------------------------------------------------------------
# phase 5: the paper's flat SemanticCache behind the fine-tuned encoder
# ---------------------------------------------------------------------------

def flat_serving_phase(dev, trainer, tok):
    from repro_torch.core import SemanticCache
    from repro_torch.data import make_query_stream
    from repro_torch.kernels.cosine_topk import kernel
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving import CachedLLMService

    stream = make_query_stream("medical", N_REQUESTS, seed=11,
                               repeat_frac=0.4)
    texts = [x.text for x in stream]
    meaning = {x.text: (x.entity, x.aspect) for x in stream}
    embed_fn = trainer.make_embed_fn(tok)
    print("  scores on the trace after fine-tuning:")
    sc = score_report(embed_fn, stream)
    if not sc["max_unrelated"] < FLAT_THRESHOLD:
        fail(f"flat threshold {FLAT_THRESHOLD} is not above the largest "
             f"score between texts of different meaning "
             f"({sc['max_unrelated']:.6f})")
    telemetry = Telemetry(tracer=Tracer(keep=N_REQUESTS))
    cache = SemanticCache(capacity=FLAT_CAPACITY, dim=trainer.cfg.d_model,
                          threshold=FLAT_THRESHOLD, telemetry=telemetry,
                          device=dev)
    svc = CachedLLMService(embed_fn, cache, None, tok)

    kernel.COUNTS["cosine_topk"] = 0
    t0 = time.perf_counter()
    served = []
    for i in range(0, N_REQUESTS, BATCH):
        served += svc.handle(texts[i:i + BATCH], tenant=0)
    wall = time.perf_counter() - t0
    launches = kernel.COUNTS["cosine_topk"]

    st = svc.stats()
    plans = st["backend"]["plans"]
    if launches != plans:
        fail(f"cosine_topk launched {launches} times for {plans} plans")
    if not (st["hits"] > 0 and st["misses"] > 0):
        fail(f"need hits and misses: {st['hits']} / {st['misses']}")
    paraphrase_hits = 0
    for r in served:
        answered = r.response[len("answer("):-1]
        if not r.response.startswith("answer(") or \
                meaning.get(answered) != meaning[r.query]:
            fail(f"request {r.query!r} answered {r.response!r}")
        paraphrase_hits += r.cache_hit and answered != r.query
    print(f"  served {len(served)} requests in {wall:.2f} s: hits "
          f"{st['hits']} ({paraphrase_hits} paraphrases, "
          f"{st['hits'] - paraphrase_hits} exact repeats), misses "
          f"{st['misses']}, hit rate {st['hit_rate']:.3f}, coalesced "
          f"{st['coalesced_misses']}, occupancy "
          f"{st['backend']['occupancy']:.4f}")
    p50 = stage_p50(telemetry)
    prof = profile(lambda: svc.handle(texts[:BATCH], tenant=0),
                   "flat serving batch")
    return {"launches": launches, "plans": plans, "p50_ms": p50,
            "profile": prof,
            "hits": st["hits"], "paraphrase_hits": paraphrase_hits,
            "hit_rate": st["hit_rate"], "max_unrelated":
            sc["max_unrelated"]}


# ---------------------------------------------------------------------------
# phase 6: an ensemble of embedders with learned mixture weights
# ---------------------------------------------------------------------------

def ensemble_embed_fn(dev, trainer, tok):
    """list[str] -> (B, 3, 768): the fine-tuned encoder (the pilot), the
    untuned seed-0 encoder (the paper's base row) and a random
    projection embedder (``launch/serve.py``'s extra panel)."""
    import numpy as np
    from repro_torch.core import EncoderEmbedder, RandomProjectionEmbedder
    cfg = encoder_config()
    untuned = EncoderEmbedder(cfg, max_len=32, seed=0, device=dev)
    proj = RandomProjectionEmbedder(dim=cfg.d_model, seed=101)
    pilot = trainer.make_embed_fn(tok)
    names = ("tuned encoder", untuned.name, proj.name)

    def embed(texts):
        return np.stack([pilot(texts), untuned.embed(texts),
                         proj.embed(texts)], axis=1)
    return embed, names


def ensemble_score_report(embed_fn, names, stream) -> dict:
    """Scores between the trace's distinct texts, per panel and fused at
    the initial uniform weights: how well each panel ranks paraphrases
    (same entity and aspect) above unrelated pairs (average precision),
    the largest fused score between texts of different meaning (the
    threshold goes above it) and the pilot's (miss coalescing compares
    pilot cosines with the fused threshold)."""
    import numpy as np
    from repro_torch.core import average_precision
    texts = [x.text for x in stream]
    emb = np.concatenate([embed_fn(texts[i:i + BATCH])
                          for i in range(0, len(texts), BATCH)])
    uniq = {t: i for i, t in enumerate(texts)}
    first = np.asarray(list(uniq.values()))
    meaning = np.asarray([hash((stream[i].entity, stream[i].aspect))
                          for i in first])
    iu = np.triu_indices(len(first), 1)
    para = meaning[iu[0]] == meaning[iu[1]]
    w = np.float32(1.0 / ENS_E)
    fused = np.zeros(len(iu[0]), np.float32)
    out = {"ap": {}}
    for e, name in enumerate(names):
        x = emb[first, e]
        sims = (x @ x.T)[iu]
        fused += w * sims
        out["ap"][name] = float(average_precision(sims, para))
        if e == 0:
            out["pilot"] = sims
        print(f"  panel {e} ({name}): paraphrase AP {out['ap'][name]:.4f}, "
              f"max unrelated {sims[~para].max():.6f}, paraphrase median "
              f"{np.median(sims[para]):.4f}, unrelated median "
              f"{np.median(sims[~para]):.4f}")
    out["fused_ap"] = float(average_precision(fused, para))
    out["max_unrelated"] = float(fused[~para].max())
    out["fused"], out["para"] = fused, para
    print(f"  fused (uniform 1/{ENS_E}): paraphrase AP {out['fused_ap']:.4f}"
          f", max unrelated {out['max_unrelated']:.6f}, paraphrase max "
          f"{fused[para].max():.6f}, paraphrase pairs above the max "
          f"unrelated {int((fused[para] > out['max_unrelated']).sum())} of "
          f"{int(para.sum())}, over {len(first)} distinct texts")
    return out


def ensemble_config(threshold: float, telemetry=None,
                    conformal: bool = False):
    from repro_torch.cache_service import (
        CacheConfig, EnsembleConfig, LearningConfig, TieringConfig,
    )
    return CacheConfig(dim=encoder_config().d_model, threshold=threshold,
                       telemetry=telemetry,
                       tiering=TieringConfig(fused=True),
                       learning=LearningConfig(learned_admission=True,
                                               conformal=conformal),
                       ensemble=EnsembleConfig(embedders=ENS_E))


def ensemble_serving_phase(dev, embed_fn, thr: float, tok) -> dict:
    """(a) The trace through ``CachedLLMService``.  Miss coalescing is
    off: the service coalesces on the pilot's cosine against the fused
    threshold, which the pilot alone exceeds for texts of different
    meaning (printed), so a coalesced member could be stored with
    another meaning's answer."""
    import numpy as np
    import torch
    from repro_torch.cache_service import CacheService, tiers
    from repro_torch.data import make_query_stream
    from repro_torch.kernels.cascade_lookup import kernel
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving import CachedLLMService

    stream = make_query_stream("medical", N_REQUESTS, seed=11,
                               repeat_frac=0.4)
    texts = [x.text for x in stream]
    meaning = {x.text: (x.entity, x.aspect) for x in stream}
    telemetry = Telemetry(tracer=Tracer(keep=N_REQUESTS))
    cache = CacheService(ensemble_config(thr, telemetry), device=dev)
    svc = CachedLLMService(embed_fn, cache, None, tok, coalesce=False)

    for name in kernel.COUNTS:
        kernel.COUNTS[name] = 0
    t0 = time.perf_counter()
    served = []
    for i in range(0, N_REQUESTS, BATCH):
        served += svc.handle(texts[i:i + BATCH], tenant=0)
    wall = time.perf_counter() - t0
    launches = dict(kernel.COUNTS)

    st = svc.stats()
    bk = st["backend"]
    plans = bk["traffic"]["plans"]
    paraphrase_hits = 0
    for r in served:
        answered = r.response[len("answer("):-1]
        if not r.response.startswith("answer(") or \
                meaning.get(answered) != meaning[r.query]:
            fail(f"ensemble: request {r.query!r} answered {r.response!r}")
        paraphrase_hits += r.cache_hit and answered != r.query
    print(f"  served {len(served)} requests in {wall:.2f} s: hits "
          f"{st['hits']} ({paraphrase_hits} paraphrases; hot "
          f"{bk['traffic']['hot_hits']}, warm {bk['traffic']['warm_hits']})"
          f", misses {st['misses']}, hit rate {st['hit_rate']:.4f}; "
          f"demotions {bk['tiers']['demotions']}, rebuilds "
          f"{bk['rebuild']['rebuilds']}, maintenance calls "
          f"{st['maintenance_calls']}; launches {launches}")
    if launches["cascade_lookup_ensemble"] != plans:
        fail(f"ensemble kernel launched "
             f"{launches['cascade_lookup_ensemble']} times for {plans} "
             "plans")
    if not (st["hits"] > 0 and st["misses"] > 0):
        fail(f"ensemble: need hits and misses: {st['hits']} / "
             f"{st['misses']}")
    if bk["rebuild"]["rebuilds"] < 1 or bk["tiers"]["demotions"] < 1:
        fail("ensemble: no flush + IVF rebuild happened")
    lrn = bk["learning"]
    print(f"  feedback: {lrn['feedback_events']} events, "
          f"{lrn['duplicate_events']} duplicates (the echo backend labels "
          f"none), refits applied {lrn['refits_applied']}, weight refits "
          f"applied {lrn['weight_refits_applied']}")
    p50 = stage_p50(telemetry)

    # the final tiers answer the same through the kernel and four-op
    emb = embed_fn(texts[-BATCH:])
    if emb.shape != (BATCH, ENS_E, encoder_config().d_model) \
            or not np.isfinite(emb).all() \
            or np.abs(np.linalg.norm(emb, axis=2) - 1).max() > 1e-3:
        fail(f"bad ensemble embeddings: {emb.shape}")
    qd = torch.as_tensor(emb, device=dev)
    w = torch.full((BATCH, ENS_E), 1.0 / ENS_E, device=dev)
    qt = torch.zeros(BATCH, dtype=torch.int32, device=dev)
    th = torch.full((BATCH,), thr, device=dev)
    res = [tiers.ensemble_cascade_query(
        cache.hot, cache.warm, cache.ens, qd, w, qt, th, k=cache.topk,
        n_probe=cache._n_probe, tail=cache._tail, fused=f)
        for f in (True, False)]
    torch.cuda.synchronize()
    for name in ("value_ids", "hot_slots", "hot_hit", "hit"):
        if not torch.equal(getattr(res[0], name), getattr(res[1], name)):
            fail(f"ensemble final tiers: fused vs four-op {name} differ")
    err = max(float((res[0].scores - res[1].scores).abs().max()),
              float((res[0].panel_scores
                     - res[1].panel_scores).abs().max()))
    if err > SCORE_ATOL:
        fail(f"ensemble final tiers: fused vs four-op differ by {err:.3g}")
    print(f"  final tiers: fused and four-op agree (max |dscore| "
          f"{err:.3g}); pilot panel equal to the base keys: "
          f"{bool(torch.equal(cache.ens.hot_keys[0], cache.hot.keys))}")
    prof = profile(lambda: svc.handle(texts[:BATCH], tenant=0),
                   "ensemble serving batch")
    return {"launches": launches["cascade_lookup_ensemble"], "plans": plans,
            "p50_ms": p50, "hits": st["hits"], "hit_rate": st["hit_rate"],
            "paraphrase_hits": paraphrase_hits, "profile": prof}


def ensemble_learning_phase(dev, embed_fn, names, thr: float,
                            conformal: bool = False, embs=None) -> dict:
    """(b) A fresh service over the trace on two tenants (batches
    alternate), each miss answered with its meaning's canonical
    response, ``maintenance()`` after every commit.  With ``conformal``
    (phase 8(c)) every hit is audited as the scenario bench does (a
    false hit iff another (entity, aspect)) and fed to the §14.3 window;
    ``embs`` reuses the batches' embeddings of an earlier run."""
    import numpy as np
    from repro_torch.cache_service import CacheRequest, CacheService
    from repro_torch.data import make_query_stream
    from repro_torch.kernels.cascade_lookup import kernel

    stream = make_query_stream("medical", N_REQUESTS, seed=11,
                               repeat_frac=0.4)
    canon = {(x.entity, x.aspect): f"canon({x.entity}|{x.aspect})"
             for x in stream}
    cache = CacheService(ensemble_config(thr, conformal=conformal),
                         device=dev)
    counts = {t: {"queries": 0, "hits": 0, "false_hits": 0} for t in (0, 1)}
    fb = cache.feedback
    embs = [] if embs is None else list(embs)
    fresh = not embs
    floor_above = {0: False, 1: False}
    kernel.COUNTS["cascade_lookup_ensemble"] = 0
    t0 = time.perf_counter()
    for b, i in enumerate(range(0, N_REQUESTS, BATCH)):
        batch = stream[i:i + BATCH]
        texts = [x.text for x in batch]
        tenant = b % 2
        if fresh:
            embs.append(embed_fn(texts))
        plan = cache.plan(CacheRequest.build(embs[b], tenant, texts=texts),
                          coalesce=False)
        want = [canon[(x.entity, x.aspect)] for x in batch]
        if conformal:
            for i in np.flatnonzero(plan.hit):
                cache.feedback.observe_hit_audit(
                    tenant, float(plan.scores[i]),
                    plan.responses[i] == want[i])
        c = counts[tenant]
        c["queries"] += len(batch)
        c["hits"] += int(plan.hit.sum())
        c["false_hits"] += sum(h and r != w for h, r, w in
                               zip(plan.hit, plan.responses, want))
        cache.commit(plan, [None if h else w
                            for h, w in zip(plan.hit, want)])
        cache.maintenance()
        if conformal:
            for t in floor_above:
                f = fb.conformal_floor(t)
                floor_above[t] |= f is not None \
                    and f > cache.policies.get(t).threshold
    wall = time.perf_counter() - t0
    launches = kernel.COUNTS["cascade_lookup_ensemble"]
    plans = cache.stats_snapshot().traffic["plans"]
    w_applied = [r for r in fb.weight_refit_log if r.applied]
    t_applied = [r for r in fb.refit_log if r.applied]
    budget = fb.config.max_false_hit_rate
    print(f"  {N_REQUESTS} queries on 2 tenants in {wall:.2f} s; "
          f"{fb.counters['events']} feedback events "
          f"({fb.counters['duplicate_events']} duplicates), "
          f"{fb.counters['ensemble_events']} ensemble events; weight "
          f"refits applied {len(w_applied)} of "
          f"{len(fb.weight_refit_log)}, threshold refits applied "
          f"{len(t_applied)} of {len(fb.refit_log)}; launches {launches} "
          f"for {plans} plans")
    out = {"launches": launches, "plans": plans, "tenants": {},
           "weight_refits": len(w_applied), "threshold_refits":
           len(t_applied), "embs": embs, "floor_above": floor_above}
    weights = cache.policies.weights_state()
    for t, c in counts.items():
        w = weights.get(t, [1.0 / ENS_E] * ENS_E)
        pol = cache.policies.get(t)
        fh = c["false_hits"] / max(c["hits"], 1)
        floor = fb.conformal_floor(t) if conformal else None
        out["tenants"][t] = dict(weights=w, threshold=pol.threshold,
                                 margin=pol.admission_margin,
                                 hit_rate=c["hits"] / c["queries"],
                                 false_hits=c["false_hits"],
                                 false_hit_share=fh, floor=floor)
        print(f"  tenant {t}: weights " + ", ".join(
            f"{n} {x:.4f}" for n, x in zip(names, w))
            + f"; threshold {thr:.6f} -> {pol.threshold:.6f} (margin "
            f"{pol.admission_margin:.4f}"
            + (f"; conformal floor {floor:.6f}" if floor is not None
               else "") + "); hit rate "
            f"{c['hits'] / c['queries']:.4f}; false hits {c['false_hits']}"
            f" of {c['hits']} hits ({fh:.4f}; budget {budget})")
    for r in w_applied[:3] + w_applied[-2:]:
        print(f"  weight refit tenant {r.tenant}: "
              f"{[round(x, 4) for x in r.old_weights]} -> "
              f"{[round(x, 4) for x in r.new_weights]}, threshold "
              f"{r.old_threshold:.6f} -> {r.new_threshold:.6f} "
              f"({r.n_events} events, {r.n_duplicates} duplicates)")
    if launches != plans:
        fail(f"ensemble learning: {launches} launches for {plans} plans")
    if not w_applied or not t_applied:
        fail(f"ensemble learning: weight refits applied {len(w_applied)}, "
             f"threshold refits applied {len(t_applied)}; need one of each")
    return out


# ---------------------------------------------------------------------------
# phase 2: the attention kernels
# ---------------------------------------------------------------------------

def attention_bound_ms(n_bytes: int, flops: float, dtype,
                       pv_bf16: bool = False):
    """The least time for attention's bytes and flops in ``dtype``: bf16 at
    the bf16 tensor-core rate, float32 at the 3xTF32 rate.  ``pv_bf16``
    (the float32 bf16-accumulate mode, whose weights and V are bf16 by its
    function): the P V half of the flops at the bf16 rate."""
    import torch
    rate = BF16_FLOPS if dtype == torch.bfloat16 else TF32X3_FLOPS
    pv_rate = BF16_FLOPS if pv_bf16 else rate
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / 2 / rate + flops / 2 / pv_rate
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def flash_case(dev, B, H, KV, S, hd, causal, window, dtype, seed):
    """Model-layout q, k, v, the plain version's output, the live pairs
    of the mask, and the SDPA call with KV heads expanded (prepared
    outside its timing)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ref
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    mask = ref.position_mask(S, S, causal=causal, window=window, device=dev)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
    sdpa = dict(attn_mask=mask) if window else dict(is_causal=causal)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
    return q, k, v, int(mask.sum()), library


def decode_case(dev, B, H, KV, L, hd, cur, window, dtype, seed):
    import torch
    import torch.nn.functional as F
    from repro_torch.models.attention import decode_mask
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, L, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, L, KV, hd, generator=g, device=dev).to(dtype)
    slot = torch.arange(L, device=dev)
    newest = cur - ((cur - slot) % L)         # newest position <= cur
    pos = torch.where(newest >= 0, newest, -1).expand(B, L).contiguous()
    valid = decode_mask(pos, cur, window)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(H // KV, 1).contiguous()
    am = valid[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
    return q, k, v, valid, library


def attention_kernel_phase(dev):
    """Flash and decode attention against their plain versions at the
    decoder's shapes and beyond, bf16 and fp32, and the times of the
    kernel, the plain version and SDPA (bf16 and fp32 each)."""
    import torch
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import kernel as fkern
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    out = {"flash": {"max_abs_err": 0.0, "by_shape": {}},
           "flash_acc_bf16": {"max_abs_err": 0.0, "by_shape": {}},
           "decode": {"max_abs_err": 0.0, "by_shape": {}}}

    def check(got, want, dtype, what):
        if got.shape != want.shape or got.dtype != want.dtype \
                or not torch.isfinite(got).all():
            fail(f"{what}: {tuple(got.shape)}/{got.dtype} vs plain "
                 f"{tuple(want.shape)}/{want.dtype}")
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        err = (got.float() - want.float()).abs()
        bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
        if bad.any():
            fail(f"{what}: {int(bad.sum())} outputs off, max |diff| "
                 f"{float(err.max()):.3g}")
        return float(err.max())

    def check_acc_bf16(got, want, want_f32, v, what):
        """The bf16-accumulate mode against its plain version (see
        ``ACC_BF16_MAX_REL``); (max, mean |diff|, the plain version's
        mean True-vs-False gap)."""
        if got.shape != want.shape or got.dtype != want.dtype \
                or not torch.isfinite(got).all():
            fail(f"{what}: {tuple(got.shape)}/{got.dtype} vs plain "
                 f"{tuple(want.shape)}/{want.dtype}")
        err = (got.float() - want.float()).abs()
        gap = float((want_f32.float() - want.float()).abs().mean())
        lim = ACC_BF16_MAX_REL * float(v.float().abs().max())
        if not (float(err.max()) <= lim
                and float(err.mean()) <= ACC_BF16_MEAN_SHARE * gap):
            fail(f"{what}: max |diff| {float(err.max()):.3g} (limit "
                 f"{lim:.3g}), mean {float(err.mean()):.3g} (limit "
                 f"{ACC_BF16_MEAN_SHARE} x gap {gap:.3g})")
        return float(err.max()), float(err.mean()), gap

    def acc_bf16_row(tag, q, k, v, want, kw, n_bytes, flops, row):
        """The bf16-accumulate mode (attn_f32=False) at the reference's
        branch for this length (dense, or 1024-key chunks), held to its
        plain version and timed beside the float32-accumulate ``row`` of
        the same inputs, with the route the launch takes; its bound takes
        P V at the bf16 rate (its weights and V are bf16)."""
        S, hd = q.shape[1], q.shape[3]
        bound, by = attention_bound_ms(n_bytes, flops, q.dtype, pv_bf16=True)

        def plain_b():
            return fref.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                acc_dtype=torch.bfloat16, **kw)

        def kern_b():
            return fops.flash_attention(q, k, v, acc_bf16=True, **kw)
        got_b, want_b = kern_b(), plain_b().transpose(1, 2)
        torch.cuda.synchronize()
        err_b, mean_b, gap = check_acc_bf16(
            got_b, want_b, want, v, f"flash_attention acc_bf16 {tag}")
        fb = out["flash_acc_bf16"]
        fb["max_abs_err"] = max(fb["max_abs_err"], err_b)
        chunk = fref.kv_chunk_for(S, S)
        rowb = dict(ms=cuda_ms(kern_b), plain_ms=cuda_ms(plain_b, iters=5),
                    library_ms=None, bound_ms=bound, bound_by=by,
                    max_abs_err=err_b, mean_abs_err=mean_b,
                    plain_gap_mean=gap, graph_ms=graph_ms(kern_b),
                    plain_graph_ms=graph_ms(plain_b, iters=5),
                    device_kernels=device_kernels(kern_b), kv_chunk=chunk)
        rowb["f32_acc_graph_ms"] = row["graph_ms"]
        rowb["ratio_to_f32_acc"] = rowb["graph_ms"] / row["graph_ms"]
        r = fkern.acc_bf16_route(S, S, hd, kw["causal"], kw["window"],
                                 chunk, q.dtype == torch.float32)
        rowb.update(route=r.route, warps=r.warps, cap=r.cap, smem=r.smem)
        extra = (f"; route {r.route}, {r.warps} warps, "
                 f"{'at most ' if q.dtype == torch.float32 else ''}"
                 f"{r.smem} B shared")
        fb["by_shape"][tag] = rowb
        print(f"  flash_attention acc_bf16 {tag} (kv_chunk {chunk}): max "
              f"|diff| {err_b:.3g} (limit "
              f"{ACC_BF16_MAX_REL * float(v.float().abs().max()):.3g}), "
              f"mean {mean_b:.3g} (plain True-vs-False gap {gap:.3g}); "
              f"eager: kernel {rowb['ms']:.4f} ms, plain "
              f"{rowb['plain_ms']:.4f}; graph: kernel {rowb['graph_ms']:.4f}"
              f" ({rowb['ratio_to_f32_acc']:.2f}x the float32-accumulate "
              f"{row['graph_ms']:.4f}), plain {rowb['plain_graph_ms']:.4f}; "
              f"bound {bound:.4f} ({by}); device kernels per call "
              f"{rowb['device_kernels']}; library none{extra}")

    edges = tuple((n, B, H, KV, S, hd, c, w, (torch.bfloat16,))
                  for n, B, H, KV, S, hd, c, w in FLASH_ACC_BF16_EDGES)
    for i, (name, B, H, KV, S, hd, causal, window, dtypes) in enumerate(
            tuple(f + ((torch.bfloat16, torch.float32),)
                  for f in FLASH_SHAPES) + edges):
        for dtype in dtypes:
            q, k, v, live, library = flash_case(dev, B, H, KV, S, hd, causal,
                                                window, dtype, 20 + i)
            kw = dict(causal=causal, window=window)

            def plain():
                return fref.flash_attention(q.transpose(1, 2),
                                            k.transpose(1, 2),
                                            v.transpose(1, 2), **kw)

            def kern():
                return fops.flash_attention(q, k, v, **kw)
            got, want = kern(), plain().transpose(1, 2)
            torch.cuda.synchronize()
            tag = f"{name} {str(dtype)[6:]}"
            err = check(got, want, dtype, f"flash_attention {tag}")
            out["flash"]["max_abs_err"] = max(out["flash"]["max_abs_err"],
                                              err)
            es = q.element_size()
            n_bytes = es * (2 * B * S * H * hd + 2 * B * S * KV * hd)
            flops = 4.0 * hd * live * B * H
            bound, by = attention_bound_ms(n_bytes, flops, dtype)
            row = dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                       library_ms=cuda_ms(library), bound_ms=bound,
                       bound_by=by, max_abs_err=err,
                       graph_ms=graph_ms(kern),
                       plain_graph_ms=graph_ms(plain, iters=5),
                       library_graph_ms=graph_ms(library),
                       device_kernels=device_kernels(kern))
            if dtype == torch.bfloat16:
                row["warps"] = fkern.warps(S)
                row["graph_ms_by_warps"] = {}
                for w in (2, 4):
                    with forced(fkern, "warps", w):
                        row["graph_ms_by_warps"][w] = graph_ms(kern)
            out["flash"]["by_shape"][tag] = row
            print(f"  flash_attention {tag} (B={B} S={S} H={H} KV={KV} "
                  f"hd={hd} causal={causal} W={window}): max |diff| "
                  f"{err:.3g}; eager: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}; "
                  f"graph: kernel {row['graph_ms']:.4f}, plain "
                  f"{row['plain_graph_ms']:.4f}, SDPA "
                  f"{row['library_graph_ms']:.4f}; bound {bound:.4f} ({by})"
                  f"; device kernels per call {row['device_kernels']}"
                  + (f"; {row['warps']} warps (graph ms by warps "
                     f"{row['graph_ms_by_warps']})" if "warps" in row
                     else ""))

            acc_bf16_row(tag, q, k, v, want, kw, n_bytes, flops, row)
    for i, (name, B, H, KV, L, hd, cur, window) in enumerate(DECODE_SHAPES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid, library = decode_case(dev, B, H, KV, L, hd, cur,
                                                  window, dtype, 40 + i)

            def plain():
                return dref.decode_attention(q[:, 0], k, v, valid)

            def kern():
                return dops.decode_attention(q, k, v, valid)
            got, want = kern()[:, 0], plain()
            torch.cuda.synchronize()
            tag = f"{name} {str(dtype)[6:]}"
            err = check(got, want, dtype, f"decode_attention {tag}")
            out["decode"]["max_abs_err"] = max(out["decode"]["max_abs_err"],
                                               err)
            es = q.element_size()
            n_valid = int(valid.sum())          # rows the function needs
            n_bytes = es * (2 * B * H * hd + 2 * n_valid * KV * hd) \
                + B * L
            bound, by = attention_bound_ms(n_bytes, 4.0 * hd * n_valid * H,
                                           dtype)
            row = dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, iters=5),
                       library_ms=cuda_ms(library), bound_ms=bound,
                       bound_by=by, max_abs_err=err,
                       graph_ms=graph_ms(kern),
                       plain_graph_ms=graph_ms(plain, iters=5),
                       library_graph_ms=graph_ms(library),
                       device_kernels=device_kernels(kern))
            out["decode"]["by_shape"][tag] = row
            print(f"  decode_attention {tag} (B={B} L={L} H={H} KV={KV} "
                  f"hd={hd}, {n_valid // B} valid slots a row): max |diff| "
                  f"{err:.3g}; eager: kernel {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}; "
                  f"graph: kernel {row['graph_ms']:.4f}, plain "
                  f"{row['plain_graph_ms']:.4f}, SDPA "
                  f"{row['library_graph_ms']:.4f}; bound {bound:.4f} ({by})"
                  f"; device kernels per call {row['device_kernels']}, "
                  f"splits {decode_splits(dev, q, k)}")
    # split edges, held to the plain version (not timed): a cache whose
    # length is a multiple of neither the split nor the 64-row tile, and
    # a split whose every slot is masked
    for i, (name, B, H, KV, L, hd, cur, window, dead) in enumerate(
            DECODE_EDGES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, valid, _ = decode_case(dev, B, H, KV, L, hd, cur,
                                            window, dtype, 60 + i)
            S, rows = decode_splits(dev, q, k)
            if dead is not None:
                valid[:, dead[0]:dead[1]] = False
            got = dops.decode_attention(q, k, v, valid)[:, 0]
            want = dref.decode_attention(q[:, 0], k, v, valid)
            torch.cuda.synchronize()
            tag = f"{name} {str(dtype)[6:]}"
            err = check(got, want, dtype, f"decode_attention {tag}")
            out["decode"]["max_abs_err"] = max(out["decode"]["max_abs_err"],
                                               err)
            print(f"  decode_attention {tag} (B={B} L={L} H={H} KV={KV} "
                  f"hd={hd}; {S} splits of {rows} rows, the last "
                  f"{L - (S - 1) * rows}"
                  + (f"; slots {dead[0]}..{dead[1] - 1} masked"
                     + (" (a whole split)" if S > 1 and dead[0] % rows == 0
                        and dead[1] - dead[0] == rows else "")
                     if dead is not None else "")
                  + f"): max |diff| {err:.3g}")
    return out


def decode_splits(dev, q, k):
    """(S, rows) the decode wrapper picks for these inputs on this card."""
    import torch
    from repro_torch.kernels.decode_attention import kernel
    H, KV = q.shape[2], k.shape[2]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return kernel.splits(q.shape[0], kernel.units(
        H, KV, kernel.uses_mma(q.dtype, H // KV)), k.shape[1], n_sm)


# ---------------------------------------------------------------------------
# phase 7: cache misses answered by the full-width decoder
# ---------------------------------------------------------------------------

def decoder_config():
    from repro_torch.configs import get_config
    cfg = get_config(DECODER)
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype)
    if widths != (32, 3072, 32, 32, 96, 8192, 32064, "bfloat16"):
        fail(f"{DECODER} is not at its published widths: {widths}")
    return cfg


def attention_layers(cfg) -> int:
    """The decoder's attention layers: one flash launch each a prefill,
    one decode launch each a step."""
    from repro_torch.configs.base import ATTN
    return sum(spec.mixer == ATTN for spec in cfg.layer_specs())


def attention_counts(reset: bool = False) -> dict:
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    if reset:
        fk.COUNTS["flash_attention"] = 0
        dk.COUNTS["decode_attention"] = 0
    return {"flash_attention": fk.COUNTS["flash_attention"],
            "decode_attention": dk.COUNTS["decode_attention"]}


def generation_phase(dev, cfg) -> dict:
    """(a) 32 greedy tokens for 8 prompts through ``ServeEngine``."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine
    t0 = time.perf_counter()
    lm = LM(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"  {cfg.name}: {n_params:,} params (float32 master weights, "
          f"{cfg.dtype} activations), built in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(lm, max_len=GEN_PROMPT + GEN_NEW)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT)).astype(np.int32)
    engine.generate(prompts, 2)                         # warm
    torch.cuda.synchronize()
    attention_counts(reset=True)
    t0 = time.perf_counter()
    res = engine.generate(prompts, GEN_NEW)
    wall = time.perf_counter() - t0
    counts = attention_counts()
    L = cfg.n_layers
    if counts != {"flash_attention": L, "decode_attention": L * GEN_NEW}:
        fail(f"generate: launches {counts}, expected {L} flash (one "
             f"prefill) and {L * GEN_NEW} decode ({GEN_NEW} steps)")
    if res.tokens.shape != (GEN_B, GEN_NEW) or res.tokens.min() < 0 \
            or res.tokens.max() >= cfg.vocab_size:
        fail(f"generate: bad tokens {res.tokens.shape}")

    def prefill():
        out = lm.prefill(prompts, GEN_PROMPT + GEN_NEW)
        torch.cuda.synchronize()
        return out
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        prefill()
        times.append(time.perf_counter() - t1)
    prefill_ms = 1e3 * statistics.median(times)
    decode_ms = (1e3 * wall - prefill_ms) / GEN_NEW
    tok_s = GEN_B * GEN_NEW / wall
    print(f"  generate: {GEN_B} x {GEN_NEW} tokens in {wall * 1e3:.1f} ms "
          f"({tok_s:.1f} tokens/s); prefill {prefill_ms:.3f} ms (B={GEN_B}, "
          f"S={GEN_PROMPT}), decode {decode_ms:.3f} ms per step; launches "
          f"{counts}; first row {res.tokens[0, :8].tolist()}")
    _, state = prefill()
    tok = torch.as_tensor(res.tokens[:, :1], device=dev)
    prof = profile(lambda: lm.decode_step(state, tok), "decode step")
    return {"lm": lm, "engine": engine, "launches": counts,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tokens_per_s": tok_s, "generate_ms": wall * 1e3,
            "profile": prof, "prompts": prompts, "tokens": res.tokens}


def llm_serving_phase(dev, engine, trainer, tok) -> dict:
    """(c) The paper's deployment: the tuned encoder, the tiered cache
    and the decoder answering each miss-group leader."""
    from repro_torch.cache_service import (
        CacheConfig, CacheService, TieringConfig,
    )
    from repro_torch.data import HashTokenizer, make_query_stream
    from repro_torch.kernels.cascade_lookup import kernel as ck
    from repro_torch.obs import Telemetry, Tracer
    from repro_torch.serving import CachedLLMService
    cfg = engine.cfg
    generate = engine.generate
    rows = []

    def counting(ids, *a, **k):
        rows.append(len(ids))
        return generate(ids, *a, **k)

    engine.generate = counting            # undone below: del
    telemetry = Telemetry(tracer=Tracer(keep=LLM_REQUESTS))
    cache = CacheService(CacheConfig(
        dim=trainer.cfg.d_model, threshold=FLAT_THRESHOLD,
        telemetry=telemetry, tiering=TieringConfig(fused=True)), device=dev)
    # the decoder's own tokenizer: the encoder's ids (vocab 50368) would
    # fall outside Phi-3-mini's 32064-row table
    svc = CachedLLMService(trainer.make_embed_fn(tok), cache, engine,
                           HashTokenizer(vocab_size=cfg.vocab_size),
                           max_query_len=GEN_PROMPT,
                           max_new_tokens=LLM_NEW_TOKENS)
    texts = [x.text for x in make_query_stream("medical", LLM_REQUESTS,
                                               seed=11, repeat_frac=0.4)]
    attention_counts(reset=True)
    ck.COUNTS["cascade_lookup"] = 0
    t0 = time.perf_counter()
    served = []
    for i in range(0, LLM_REQUESTS, BATCH):
        served += svc.handle(texts[i:i + BATCH], tenant=0)
    wall = time.perf_counter() - t0
    counts = attention_counts()
    del engine.generate
    st = svc.stats()
    plans = st["backend"]["traffic"]["plans"]
    L, calls = attention_layers(cfg), len(rows)
    want = {"flash_attention": L * calls,
            "decode_attention": L * LLM_NEW_TOKENS * calls}
    print(f"  served {len(served)} requests in {wall:.2f} s: hits "
          f"{st['hits']}, misses {st['misses']} ({st['generations']} "
          f"generations in {calls} engine calls, {st['coalesced_misses']} "
          f"coalesced), hit rate {st['hit_rate']:.4f}; launches {counts}")
    if counts != want:
        fail(f"llm serving: launches {counts}, expected {want}")
    if ck.COUNTS["cascade_lookup"] != plans:
        fail(f"llm serving: cascade kernel launched "
             f"{ck.COUNTS['cascade_lookup']} times for {plans} plans")
    if sum(rows) != st["generations"] or \
            st["generations"] + st["coalesced_misses"] != st["misses"]:
        fail(f"llm serving: {sum(rows)} generated rows, {st['generations']} "
             f"leaders, {st['misses']} misses")
    if not (st["hits"] > 0 and st["misses"] > 0):
        fail(f"llm serving: need hits and misses: {st['hits']} / "
             f"{st['misses']}")
    generated = {r.response for r in served if not r.cache_hit}
    for r in served:
        ids = r.response.split()
        if len(ids) != LLM_NEW_TOKENS or not all(
                0 <= int(x) < cfg.vocab_size for x in ids):
            fail(f"llm serving: {r.query!r} answered {r.response!r}")
        if r.cache_hit and r.response not in generated:
            fail(f"llm serving: hit {r.query!r} answered with no "
                 "generation of this run")
    p50 = stage_p50(telemetry)
    return {"launches": counts, "calls": calls, "p50_ms": p50,
            "cascade_launches": ck.COUNTS["cascade_lookup"], "plans": plans,
            "hits": st["hits"], "misses": st["misses"],
            "generations": st["generations"], "hit_rate": st["hit_rate"],
            "wall_s": wall}


def decode_forward_phase(dev, cfg) -> dict:
    """(b) float32 activations, the same seed: teacher-forced decode
    logits against ``forward_lm`` at every position after the prompt."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    cfg32 = cfg.replace(dtype="float32")
    lm = LM(cfg32, seed=0, device=dev)
    S, t0 = 48, 32
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, S)), device=dev)
    attention_counts(reset=True)
    with torch.no_grad():
        full, _ = lm.forward_lm(toks)
        logits, state = lm.prefill(toks[:, :t0], S)
        errs = [float((logits - full[:, t0 - 1]).abs().max())]
        agree = [bool(torch.equal(logits.argmax(-1),
                                  full[:, t0 - 1].argmax(-1)))]
        for t in range(t0, S):
            logits, state = lm.decode_step(state, toks[:, t:t + 1])
            errs.append(float((logits - full[:, t]).abs().max()))
            agree.append(bool(torch.equal(logits.argmax(-1),
                                          full[:, t].argmax(-1))))
    counts = attention_counts()
    scale = float(full.abs().max())
    print(f"  float32 decode vs forward_lm over {len(errs)} positions: max "
          f"|dlogit| {max(errs):.3g} (logits up to {scale:.3f}); argmax "
          f"equal at {sum(agree)} of {len(agree)}; launches {counts}")
    if max(errs) > DECODE_ATOL:
        fail(f"decode vs forward_lm: max |dlogit| {max(errs):.3g} > "
             f"{DECODE_ATOL}")
    if counts != {"flash_attention": 2 * cfg.n_layers,
                  "decode_attention": (S - t0) * cfg.n_layers}:
        fail(f"decode vs forward_lm: launches {counts}")
    return {"max_abs_err": max(errs), "positions": len(errs)}


class attn_f32_off:
    """Within the block the model's attention layers run at
    ``attn_f32=False`` (bf16 softmax weights and PV sums on the
    full-sequence paths; decode is float32 either way); the weights are
    the model's own."""

    def __init__(self, lm):
        self.attns = [blk.attn for blk in lm.layers if hasattr(blk, "attn")]

    def __enter__(self):
        self.saved = [a.cfg for a in self.attns]
        for a in self.attns:
            a.cfg = a.cfg.replace(attn_f32=False)

    def __exit__(self, *exc):
        for a, cfg in zip(self.attns, self.saved):
            a.cfg = cfg


def logit_gap(kern, plain, plain_f32) -> dict:
    """Kernel logits against the plain versions' in the same mode, beside
    the plain versions' own attn_f32 True-vs-False gap."""
    err = (kern - plain).abs()
    return {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
            "argmax_agree": float((kern.argmax(-1) == plain.argmax(-1))
                                  .float().mean()),
            "gap_mean": float((plain_f32 - plain).abs().mean()),
            "logits_max": float(plain.abs().max())}


def acc_bf16_phase(dev, cfg, gn) -> dict:
    """7(d) ``attn_f32=False`` on 7(a)'s full-width model: the same
    generation (launches as at ``attn_f32=True``, greedy tokens that agree
    with 7(a)'s counted); teacher-forced prefill and decode logits through
    the kernels against the plain versions in the same mode (bf16, held as
    10(b): mean and argmax), beside the plain versions at
    ``attn_f32=True``; a ``LONG_PROMPT``-token prefill (the chunked
    branch) the same way; and a float32 copy cut to
    ``ACC_BF16_FP32_LAYERS`` layers, held under phase 2's bounds for the
    mode (``ACC_BF16_MAX_REL`` of the logits' scale, ``ACC_BF16_MEAN_SHARE``
    of the gap)."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    lm, engine, prompts = gn["lm"], gn["engine"], gn["prompts"]
    L, steps = cfg.n_layers, GEN_NEW - 1
    toks = torch.as_tensor(gn["tokens"], device=dev)
    with attn_f32_off(lm):
        engine.generate(prompts, 2)                     # warm
        torch.cuda.synchronize()
        attention_counts(reset=True)
        t0 = time.perf_counter()
        res = engine.generate(prompts, GEN_NEW)
        wall = time.perf_counter() - t0
        counts = attention_counts()
        times = []
        for _ in range(5):
            t1 = time.perf_counter()
            lm.prefill(prompts, GEN_PROMPT + GEN_NEW)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        kern = moe_teacher_forced(lm, prompts, toks, steps)
        with plain_attention():
            plain = moe_teacher_forced(lm, prompts, toks, steps)
    with plain_attention():
        plain32 = moe_teacher_forced(lm, prompts, toks, steps)
    if counts != {"flash_attention": L, "decode_attention": L * GEN_NEW}:
        fail(f"attn_f32=False generate: launches {counts}, expected {L} "
             f"flash and {L * GEN_NEW} decode (as at attn_f32=True)")
    prefill_ms = 1e3 * statistics.median(times)
    decode_ms = (1e3 * wall - prefill_ms) / GEN_NEW
    tok_s = GEN_B * GEN_NEW / wall
    agree = float((res.tokens == gn["tokens"]).mean())
    print(f"  generate at attn_f32=False: {tok_s:.1f} tokens/s (True "
          f"{gn['tokens_per_s']:.1f}); prefill {prefill_ms:.3f} ms (True "
          f"{gn['prefill_ms']:.3f}), decode {decode_ms:.3f} ms a step (True "
          f"{gn['decode_ms']:.3f}); launches {counts}; greedy tokens equal "
          f"to 7(a)'s at {agree:.4f} of {res.tokens.size}")
    tf = logit_gap(kern, plain, plain32)
    print(f"  bf16 teacher-forced (prefill + {steps} steps), kernels vs "
          f"plain at attn_f32=False: max |dlogit| {tf['max_abs_err']:.4g}, "
          f"mean {tf['mean_abs_err']:.4g} (tolerance {MOE_BF16_MEAN_TOL}), "
          f"argmax equal at {tf['argmax_agree']:.4f} (tolerance "
          f"{MOE_BF16_AGREE}); plain True-vs-False mean gap "
          f"{tf['gap_mean']:.4g}; logits up to {tf['logits_max']:.3f}")
    if not torch.isfinite(kern).all() or tf["mean_abs_err"] > \
            MOE_BF16_MEAN_TOL or tf["argmax_agree"] < MOE_BF16_AGREE:
        fail(f"attn_f32=False bf16: kernel logits off the plain path's: "
             f"{tf}")
    del kern, plain, plain32
    long = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (1, LONG_PROMPT)).astype(np.int32)

    def long_ms() -> float:
        """Median ms of 3 prefills of the long prompt, after 1 unclocked."""
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lm.prefill(long, LONG_PROMPT)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t1))
        return statistics.median(times[1:])
    with attn_f32_off(lm):
        attention_counts(reset=True)
        kern_l, _ = lm.prefill(long, LONG_PROMPT)
        long_counts = attention_counts()
        ms_false = long_ms()
        with plain_attention():
            plain_l, _ = lm.prefill(long, LONG_PROMPT)
    ms_true = long_ms()
    with plain_attention():
        plain32_l, _ = lm.prefill(long, LONG_PROMPT)
    if long_counts != {"flash_attention": L, "decode_attention": 0}:
        fail(f"attn_f32=False {LONG_PROMPT}-token prefill: launches "
             f"{long_counts}")
    lg = logit_gap(kern_l.float(), plain_l.float(), plain32_l.float())
    print(f"  bf16 {LONG_PROMPT}-token prefill (B=1, 1024-key chunks): "
          f"{ms_false:.1f} ms at attn_f32=False, {ms_true:.1f} ms at True "
          f"({ms_false / ms_true:.3f}x), launches {long_counts}; kernels vs "
          f"plain: max |dlogit| {lg['max_abs_err']:.4g}, mean "
          f"{lg['mean_abs_err']:.4g} (tolerance {MOE_BF16_MEAN_TOL}), "
          f"argmax equal {lg['argmax_agree'] == 1.0}; plain True-vs-False "
          f"mean gap {lg['gap_mean']:.4g}")
    if not torch.isfinite(kern_l).all() or lg["mean_abs_err"] > \
            MOE_BF16_MEAN_TOL:
        fail(f"attn_f32=False {LONG_PROMPT}-token prefill: {lg}")
    del kern_l, plain_l, plain32_l
    lm32 = LM(cfg.replace(dtype="float32", n_layers=ACC_BF16_FP32_LAYERS),
              seed=0, device=dev)
    with attn_f32_off(lm32):
        attention_counts(reset=True)
        kern = moe_teacher_forced(lm32, prompts, toks, MOE_FP32_STEPS)
        counts32 = attention_counts()
        with plain_attention():
            plain = moe_teacher_forced(lm32, prompts, toks, MOE_FP32_STEPS)
    with plain_attention():
        plain32 = moe_teacher_forced(lm32, prompts, toks, MOE_FP32_STEPS)
    del lm32
    n = ACC_BF16_FP32_LAYERS
    if counts32 != {"flash_attention": n,
                    "decode_attention": n * MOE_FP32_STEPS}:
        fail(f"attn_f32=False float32 copy: launches {counts32}")
    f32 = logit_gap(kern, plain, plain32)
    lim = ACC_BF16_MAX_REL * f32["logits_max"]
    print(f"  float32, {n} layers (prefill + {MOE_FP32_STEPS} steps): max "
          f"|dlogit| {f32['max_abs_err']:.4g} (limit {lim:.4g}), mean "
          f"{f32['mean_abs_err']:.4g} (limit {ACC_BF16_MEAN_SHARE} x gap "
          f"{f32['gap_mean']:.4g}), argmax equal at "
          f"{f32['argmax_agree']:.4f}")
    if not (f32["max_abs_err"] <= lim and f32["mean_abs_err"]
            <= ACC_BF16_MEAN_SHARE * f32["gap_mean"]):
        fail(f"attn_f32=False float32: kernel logits off the plain "
             f"path's: {f32}")
    return {"launches": counts, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "tokens_per_s": tok_s,
            "token_agreement": agree, "teacher_forced": tf,
            "long_prefill": dict(lg, ms=ms_false, ms_attn_f32=ms_true,
                                 launches=long_counts),
            "fp32": f32}


# ---------------------------------------------------------------------------
# phase 8: the cache service's maintenance loop
# ---------------------------------------------------------------------------

def embed_batches(embed_fn, texts) -> list:
    """The trace's embeddings in the serving batches of ``BATCH``."""
    return [embed_fn(texts[i:i + BATCH])
            for i in range(0, len(texts), BATCH)]


def drive_echo(cache, embs, texts, on_batch=None,
               maintain_every: int = 1) -> dict:
    """Plan / commit over the trace on one tenant, ``maintenance`` after
    every ``maintain_every``-th batch, each miss answered with the echo
    of its own text; fails on a hit answered otherwise (the threshold
    sits in the gap between scores of different texts and of equal
    texts, as in phase 3)."""
    import numpy as np
    from repro_torch.cache_service import CacheRequest
    hits, vids = 0, []
    for b, emb in enumerate(embs):
        tx = texts[b * BATCH:(b + 1) * BATCH]
        plan = cache.plan(CacheRequest.build(emb, 0, texts=tx),
                          coalesce=False)
        for h, r, q in zip(plan.hit, plan.responses, tx):
            if h and r != f"answer({q})":
                fail(f"request {q!r} answered {r!r}")
        hits += int(plan.hit.sum())
        vids.append(plan.value_ids.copy())
        cache.commit(plan, [None if h else f"answer({q})"
                            for h, q in zip(plan.hit, tx)])
        if (b + 1) % maintain_every == 0:
            cache.maintenance()
        if on_batch is not None:
            on_batch(b)
    return {"hits": hits, "misses": len(texts) - hits,
            "value_ids": np.concatenate(vids)}


def stage_hist_ms(telemetry, stages) -> dict:
    """{stage: (p50, mean)} in ms from the service's stage histogram:
    the p50 interpolated inside its bucket, the mean exact (sum over
    count)."""
    h = telemetry.stage_histogram()
    out = {}
    for s in stages:
        agg = h.aggregate(stage=s)
        if agg.count:
            out[s] = (1e3 * agg.quantile(0.5), 1e3 * agg.mean)
    return out


def cold_tier_phase(dev, embs, texts) -> dict:
    """(a) The hierarchy squeezed so the warm ring wraps, int8 warm
    rows, a host-RAM cold tier behind it; fused, then four-op."""
    import torch
    from repro_torch.cache_service import (
        CacheConfig, CacheService, TieringConfig,
    )
    from repro_torch.kernels.cascade_lookup import kernel
    from repro_torch.obs import Telemetry

    def run(fused):
        telemetry = Telemetry()
        cache = CacheService(CacheConfig(
            dim=SHAPES["D"], threshold=THRESHOLD, telemetry=telemetry,
            tiering=TieringConfig(fused=fused, warm_dtype="int8",
                                  **COLD_TIERING)), device=dev)
        kernel.COUNTS["cascade_lookup"] = 0
        t0 = time.perf_counter()
        out = drive_echo(cache, embs, texts)
        torch.cuda.synchronize()
        out.update(wall_s=time.perf_counter() - t0,
                   launches=kernel.COUNTS["cascade_lookup"],
                   stats=cache.stats_snapshot(),
                   stage_ms=stage_hist_ms(telemetry, (
                       "plan", "cold_fetch", "commit", "maintenance")))
        return out

    f, u = run(True), run(False)
    st = f["stats"]
    t, cold = st.tiers, st.tiers["cold"]
    print(f"  hot {COLD_TIERING['hot_capacity']}, warm "
          f"{COLD_TIERING['warm_capacity']} int8 (K="
          f"{COLD_TIERING['n_clusters']}), cold "
          f"{COLD_TIERING['cold_capacity']}: {len(texts)} queries in "
          f"{f['wall_s']:.2f} s; hits {f['hits']} (hot "
          f"{st.traffic['hot_hits']}, warm {st.traffic['warm_hits']}, cold "
          f"{st.traffic['cold_hits']}), misses {f['misses']}; launches "
          f"{f['launches']} for {st.traffic['plans']} plans")
    print(f"  warm-ring overwrites demoted {t['evictions_demoted']}, "
          f"dropped {t['evictions_dropped']}; cold rows {cold['cold_rows']}"
          f", fetches {cold['cold_fetches']} ({cold['cold_fetched_rows']} "
          f"rows shipped, {cold['cold_router_skips']} router skips), cold "
          f"hits {cold['cold_hits']}, promoted {cold['cold_promoted']}, "
          f"route rebuilds {cold['cold_route_rebuilds']}, final drops "
          f"{cold['cold_dropped']}")
    for name, run_ in (("fused", f), ("four-op", u)):
        print(f"  stage p50 / mean (ms, host wall incl. sync; the p50 "
              f"interpolated in its histogram bucket), {name}: " + ", ".join(
                  f"{s} {a:.3f} / {b:.3f}"
                  for s, (a, b) in run_["stage_ms"].items()))
    if f["launches"] != st.traffic["plans"]:
        fail(f"cold tier: {f['launches']} cascade launches for "
             f"{st.traffic['plans']} plans")
    if not (t["evictions_demoted"] > 0 and t["evictions_dropped"] == 0
            and cold["cold_dropped"] == 0):
        fail(f"cold tier: demoted {t['evictions_demoted']}, dropped "
             f"{t['evictions_dropped']}, final drops {cold['cold_dropped']}"
             " (want captures and no drop while the cold ring has room)")
    if not (cold["cold_fetches"] > 0 and st.traffic["cold_hits"] > 0
            and cold["cold_promoted"] > 0
            and cold["cold_route_rebuilds"] > 0):
        fail(f"cold tier: fetches {cold['cold_fetches']}, hits "
             f"{st.traffic['cold_hits']}, promotions "
             f"{cold['cold_promoted']}, route rebuilds "
             f"{cold['cold_route_rebuilds']}: need each")
    us = u["stats"]
    if (f["hits"], f["misses"]) != (u["hits"], u["misses"]) \
            or not (f["value_ids"] == u["value_ids"]).all() \
            or cold != us.tiers["cold"] or st.traffic != us.traffic:
        fail(f"cold tier: fused and four-op runs differ: hits "
             f"{f['hits']} / {u['hits']}, cold {cold} / "
             f"{us.tiers['cold']}")
    return {"launches": f["launches"], "plans": st.traffic["plans"],
            "hits": f["hits"], "misses": f["misses"], "cold": cold,
            "stage_ms": f["stage_ms"], "four_op_stage_ms": u["stage_ms"]}


def check_reachable(cache, k_tail: int) -> dict:
    """Every live row queried with its own key: the rows of the hot
    tier, of the tail window and of the published lists must answer
    (score 1 against a 0.999 threshold); a warm row newer than the index
    outside the tail window would be stranded.  An indexed row may be
    missing from the lists only as an inline rebuild leaves it out: its
    nearest centroid's list is full (``sizes == bucket``) and holds only
    lower ring slots (lists fill in slot order).  Any other unlisted row
    fails the run."""
    import numpy as np
    import torch
    from repro_torch.cache_service import tiers
    hot, warm = cache.hot, cache.warm
    cap = warm.keys.shape[0]
    valid = warm.valid.cpu().numpy()
    seq = warm.write_seq.cpu().numpy()
    idx_total = int(warm.indexed_total)
    cursor = int(warm.cursor)
    tail = set(((cursor - 1 - np.arange(k_tail)) % cap).tolist())
    members = warm.members.cpu().numpy()
    listed = set(members[members >= 0].tolist())
    fresh = valid & (seq > idx_total)
    stranded = [p for p in np.flatnonzero(fresh) if p not in tail]
    if stranded:
        fail(f"background rebuild: {len(stranded)} warm rows newer than "
             f"the published index lie outside the tail window")
    must = [p for p in np.flatnonzero(valid)
            if p in tail and seq[p] > idx_total
            or p in listed and seq[p] <= idx_total]
    unlisted = sorted(set(np.flatnonzero(valid).tolist()) - set(must))
    if unlisted:
        # the lists' own assignment: an indexed row is unchanged since
        # the snapshot, so it scores the published centroids as it did
        # (near-ties within SCORE_ATOL may have gone either way)
        sims = (warm.keys @ warm.centroids.T).cpu().numpy()
        sizes = warm.sizes.cpu().numpy()
        full, last = sizes == members.shape[1], members.max(axis=1)
        for p in unlisted:
            near = sims[p] >= sims[p].max() - SCORE_ATOL
            if not (near & full & (last < p)).any():
                fail(f"background rebuild: warm row {p} (seq {seq[p]}, "
                     f"indexed through {idx_total}) is in no list and its "
                     "nearest centroid's list is not full")
    keys = torch.cat([hot.keys[hot.valid], warm.keys[torch.as_tensor(
        must, dtype=torch.long, device=warm.keys.device)]])
    ten = torch.cat([hot.tenants[hot.valid], warm.tenants[torch.as_tensor(
        must, dtype=torch.long, device=warm.keys.device)]])
    if len(keys):
        res = tiers.cascade_query(
            hot, warm, keys, ten, torch.full((len(keys),), THRESHOLD,
                                             device=keys.device),
            k=cache.topk, n_probe=cache._n_probe, tail=cache._tail,
            fused=True)
        missed = int((~res.hit).sum())
        if missed:
            fail(f"background rebuild: {missed} of {len(keys)} hot, tail "
                 "or listed rows do not answer their own key")
    return {"checked": len(keys), "bucket_overflow": len(unlisted)}


def background_rebuild_phase(dev, embs, texts) -> dict:
    """(b) Phase 3's configuration with the double-buffered rebuild."""
    import torch
    from repro_torch.cache_service import (
        CacheConfig, CacheService, TieringConfig, tiers,
    )
    from repro_torch.kernels.cascade_lookup import kernel
    from repro_torch.obs import Telemetry
    telemetry = Telemetry()
    cache = CacheService(CacheConfig(
        dim=SHAPES["D"], threshold=THRESHOLD, telemetry=telemetry,
        tiering=TieringConfig(fused=True, background_rebuild=True)),
        device=dev)
    shadows = []
    real = cache._rebuild

    def capture(warm):
        out = real(warm)
        shadows.append((warm, out))
        return out

    cache._rebuild = capture
    reach = {"checked": 0, "bucket_overflow": 0, "calls": 0}

    def check(b):
        r = check_reachable(cache, cache._tail)
        reach["calls"] += r["checked"] > 0
        reach["checked"] += r["checked"]
        reach["bucket_overflow"] = max(reach["bucket_overflow"],
                                       r["bucket_overflow"])

    kernel.COUNTS["cascade_lookup"] = 0
    t0 = time.perf_counter()
    # a busy server: maintenance every 32nd batch, rarer than flushes
    # (one every ~9 batches once the hot tier fills), so that flushes
    # race the shadow in flight and publish it over rows appended since
    # its snapshot
    out = drive_echo(cache, embs, texts, on_batch=check,
                     maintain_every=32)
    cache.maintenance(block=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = cache.stats_snapshot()
    rb, health = st.rebuild, st.health["rebuild"]
    launches = kernel.COUNTS["cascade_lookup"]
    plans = st.traffic["plans"]
    if launches != plans + reach["calls"]:
        fail(f"background rebuild: {launches} cascade launches for "
             f"{plans} plans and {reach['calls']} reachability lookups")
    print(f"  {len(texts)} queries in {wall:.2f} s (reachability checked "
          f"after every batch: {reach['checked']} row lookups); hits "
          f"{out['hits']}, misses {out['misses']}; shadow builds started "
          f"{rb['shadow_started']}, published {health['publishes']}, "
          f"rebuilds {rb['rebuilds']} (inline ones included); plans "
          f"served while a shadow was in flight "
          f"{health['overlap_plans_total']}; publish stall p99 "
          f"{health['stall_p99_s'] * 1e3:.3f} ms; rows beyond a bucket's "
          f"capacity at most {reach['bucket_overflow']}; cascade launches "
          f"{launches} ({plans} plans, {reach['calls']} reachability "
          "lookups)")
    if rb["shadow_started"] < 1 or health["publishes"] < 1:
        fail(f"background rebuild: {rb['shadow_started']} started, "
             f"{health['publishes']} published")
    # a published shadow is the inline rebuild of its snapshot
    worst = 0.0
    for snap, shadow in shadows:
        inline = tiers.warm_rebuild(snap, cache._kmeans_iters, cache._seed)
        for name in ("members", "sizes", "indexed_total"):
            if not torch.equal(getattr(shadow, name),
                               getattr(inline, name)):
                fail(f"background rebuild: shadow {name} differs from the "
                     "inline rebuild of its snapshot")
        worst = max(worst, float((shadow.centroids
                                  - inline.centroids).abs().max()))
    if worst > SCORE_ATOL:
        fail(f"background rebuild: shadow centroids differ by {worst:.3g}")
    print(f"  {len(shadows)} shadows against the inline rebuild of their "
          f"snapshots: lists and sizes equal, centroids within {worst:.3g}")
    final_tiers_agree(cache, embs[-1], "background rebuild")
    return {"shadow_started": rb["shadow_started"], "launches": launches,
            "plans": plans,
            "published": health["publishes"],
            "overlap_plans": health["overlap_plans_total"],
            "stall_p99_ms": health["stall_p99_s"] * 1e3,
            "hits": out["hits"], "cache": cache}


def final_tiers_agree(cache, emb, what: str) -> None:
    """The final tiers answer the same through the kernel and the
    four-op composition."""
    import torch
    from repro_torch.cache_service import tiers
    dev = cache.device
    qd = torch.as_tensor(emb, device=dev)
    qt = torch.zeros(len(emb), dtype=torch.int32, device=dev)
    thr = torch.full((len(emb),), THRESHOLD, device=dev)
    kw = dict(k=cache.topk, n_probe=cache._n_probe, tail=cache._tail,
              quantized=cache.warm_dtype == "int8")
    fused = tiers.cascade_query(cache.hot, cache.warm, qd, qt, thr,
                                fused=True, **kw)
    four = tiers.cascade_query(cache.hot, cache.warm, qd, qt, thr,
                               fused=False, **kw)
    for name in ("value_ids", "hot_slots", "hot_hit", "hit"):
        if not torch.equal(getattr(fused, name), getattr(four, name)):
            fail(f"{what}: final tiers: fused vs four-op {name} differ")
    err = float((fused.scores - four.scores).abs().max())
    if err > SCORE_ATOL:
        fail(f"{what}: final tiers: fused vs four-op scores differ by "
             f"{err:.3g}")


def batcher_phase(dev, lm, maintenance) -> dict:
    """(d) ``ContinuousBatcher`` over the decoder, the cache's
    maintenance on its idle ticks."""
    import numpy as np
    import torch
    from repro_torch.serving import ContinuousBatcher, Request, scheduler
    cfg = lm.cfg
    b = ContinuousBatcher(lm, maintenance=maintenance, **BATCHER)
    rng = np.random.default_rng(17)
    for i in range(BATCHER_REQUESTS):
        b.submit(Request(uid=i, prompt=rng.integers(
            4, cfg.vocab_size, BATCHER["prompt_len"]).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 33))))
    real = scheduler._write_slot
    admitted = []

    def checked(pool, one, slot):
        real(pool, one, slot)
        for st, o in zip(pool["layers"], one["layers"]):
            for name in ("k", "v", "pos"):
                if not torch.equal(st[name][slot], o[name][0]):
                    fail(f"batcher: slot {slot} {name} differs from its "
                         "prefill state after admission")
        admitted.append(slot)

    scheduler._write_slot = checked
    attention_counts(reset=True)
    occupancy, active_ticks = [], 0
    t0 = time.perf_counter()
    try:
        while b.pending or any(r is not None for r in b.slot_req):
            n = b.tick()
            active_ticks += n > 0
            occupancy.append(n / b.n_slots)
            if b.ticks > 1000:
                fail("batcher: 1000 ticks without finishing")
        torch.cuda.synchronize()
    finally:
        scheduler._write_slot = real
    wall = time.perf_counter() - t0
    counts = attention_counts()
    st = b.stats()
    L = cfg.n_layers
    tokens = sum(len(r.generated) for r in b.finished.values())
    print(f"  {BATCHER_REQUESTS} requests on {b.n_slots} slots: "
          f"{st['ticks']} ticks ({active_ticks} with an active slot) in "
          f"{wall:.2f} s, {1e3 * wall / st['ticks']:.3f} ms per tick, "
          f"{tokens} tokens; mean occupancy "
          f"{sum(occupancy) / len(occupancy):.4f}; admission wait p50 "
          f"{st['admission_wait_p50_s'] * 1e3:.3f} ms; maintenance runs "
          f"{st['maintenance_runs']}, skips {st['maintenance_skips']}; "
          f"launches {counts}")
    if len(b.finished) != BATCHER_REQUESTS:
        fail(f"batcher: {len(b.finished)} of {BATCHER_REQUESTS} finished")
    want = {"flash_attention": L * len(admitted),
            "decode_attention": L * active_ticks}
    if counts != want or len(admitted) != BATCHER_REQUESTS:
        fail(f"batcher: launches {counts}, expected {want} for "
             f"{len(admitted)} admissions")
    if not (st["maintenance_runs"] > 0 and st["maintenance_skips"] > 0
            and st["maintenance_runs"] + st["maintenance_skips"]
            == st["ticks"]):
        fail(f"batcher: maintenance runs {st['maintenance_runs']}, skips "
             f"{st['maintenance_skips']} over {st['ticks']} ticks")
    return {"launches": counts, "ticks": st["ticks"],
            "active_ticks": active_ticks,
            "mean_occupancy": sum(occupancy) / len(occupancy),
            "admission_wait_p50_ms": st["admission_wait_p50_s"] * 1e3,
            "ms_per_tick": 1e3 * wall / st["ticks"]}


# ---------------------------------------------------------------------------
# phase 9: the online embedder refresh
# ---------------------------------------------------------------------------

def check_single_space(cache, embed_fn) -> float:
    """After a publish every valid hot and warm key is the live encoder's
    embedding of its stored text: the max |key - embedding| over them."""
    import numpy as np
    err = 0.0
    for state in (cache.hot, cache.warm):
        v = state.valid
        vids = state.value_ids[v].cpu().numpy()
        if not len(vids):
            continue
        keys = state.keys[v].cpu().numpy()
        live = embed_batches(embed_fn, [cache._texts[int(x)] for x in vids])
        err = max(err, float(np.abs(keys - np.concatenate(live)).max()))
    if not err <= KEY_ATOL:
        fail(f"refresh: a published key differs from the live encoder's "
             f"embedding of its text by {err:.3g} > {KEY_ATOL}")
    return err


def refresh_phase(dev) -> dict:
    """Phase 3's trace through plan / commit / maintenance on a service
    with ``learned_embedder`` over the untuned seed-0 encoder, each miss
    answered with its meaning's canonical response: non-blocking ticks
    for the first ``REFRESH_BATCHES`` batches, so refreshes overlap
    serving, then a closing join (the last publish) and the rest of the
    trace under the final embedder.  Tenant 1 holds the first two
    batches and is evicted while the first refresh is in flight."""
    import numpy as np
    import torch
    from repro_torch.cache_service import (
        CacheConfig, CacheRequest, CacheService, EmbedderRefreshPolicy,
        LearningConfig, TieringConfig,
    )
    from repro_torch.core import EmbedderTrainer, FinetuneConfig
    from repro_torch.data import HashTokenizer, make_query_stream
    from repro_torch.kernels.cascade_lookup import kernel as ck
    from repro_torch.kernels.contrastive import kernel as clk
    from repro_torch.obs import Telemetry

    cfg = encoder_config()
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    trainer = EmbedderTrainer(cfg, FinetuneConfig(max_len=32, seed=0),
                              device=dev)
    embed_fn = trainer.make_embed_fn(tok)
    cache = CacheService(CacheConfig(
        dim=cfg.d_model, threshold=THRESHOLD, telemetry=Telemetry(),
        tiering=TieringConfig(fused=True),
        learning=LearningConfig(
            learned_embedder=True, embedder_trainer=trainer,
            embedder_tokenizer=tok, refresh_policy=EmbedderRefreshPolicy(
                **REFRESH_POLICY))),
        device=dev)
    stream = make_query_stream("medical", N_REQUESTS, seed=11,
                               repeat_frac=0.4)
    canon = {(x.entity, x.aspect): f"canon({x.entity}|{x.aspect})"
             for x in stream}
    probe = [x.text for x in stream[:BATCH]]
    # counts are process-wide: zeroed here, never inside the thread
    ck.COUNTS["cascade_lookup"] = 0
    clk.COUNTS["contrastive_components"] = 0
    clk.COUNTS["contrastive_backward"] = 0
    boxes, stalls, waits, key_errs, evicted = [], [], [], [], set()
    per_batch = []                  # (version, queries, hits, false hits)
    stage = {True: {"embed": [], "plan": [], "commit": []},
             False: {"embed": [], "plan": [], "commit": []}}
    in_flight_plans = stale = 0
    t_start = time.perf_counter()

    # at a publish the serving thread waits for the thread (a quiescing
    # join) and then stalls for the graft and swap (the delta re-embed)
    finish = cache._finish_refresh

    def timed_finish():
        t0 = time.perf_counter()
        cache._refresh_thread.join()
        t1 = time.perf_counter()
        out = finish()
        waits.append(t1 - t0)
        stalls.append(time.perf_counter() - t1)
        return out

    cache._finish_refresh = timed_finish

    def after_publish(rep, box):
        cand = box["trainer"]
        got, want = embed_fn(probe), cand.embed_texts(probe, tok)
        if not np.array_equal(got, want):
            fail(f"refresh: after publish {rep.embed_version} the embed "
                 f"function differs from the candidate's by "
                 f"{np.abs(got - want).max():.3g}")
        key_errs.append(check_single_space(cache, embed_fn))
        live = set(int(v) for v in cache._live_vids())
        if live & evicted:
            fail(f"refresh: {len(live & evicted)} rows evicted during a "
                 "refresh are valid after its publish")

    def tick(block=False):
        # one tick may publish the refresh in flight and start the next
        pending = cache._refresh_box
        rep = cache.maintenance(block=block)
        if rep.refresh_published:
            after_publish(rep, pending)
        if rep.refresh_started:
            boxes.append(cache._refresh_box)

    for b, i in enumerate(range(0, N_REQUESTS, BATCH)):
        if b == REFRESH_BATCHES:
            serve_s = time.perf_counter() - t_start
            tick(block=True)
        batch = stream[i:i + BATCH]
        texts = [x.text for x in batch]
        tenant = 1 if b < 2 else 0
        busy = cache._refresh_thread is not None
        if busy and not evicted and b >= 2:
            # a tenant evicted while a refresh re-embeds its snapshot
            for st in (cache.hot, cache.warm):
                evicted.update(st.value_ids[st.valid & (st.tenants == 1)]
                               .tolist())
            cache.evict_tenant(1)
        t0 = time.perf_counter()
        emb = embed_fn(texts)
        t1 = time.perf_counter()
        plan = cache.plan(CacheRequest.build(emb, tenant, texts=texts),
                          coalesce=False)
        t2 = time.perf_counter()
        in_flight_plans += busy
        want = [canon[(x.entity, x.aspect)] for x in batch]
        rc = cache.commit(plan, [None if h else w
                                 for h, w in zip(plan.hit, want)])
        t3 = time.perf_counter()
        for name, dt in (("embed", t1 - t0), ("plan", t2 - t1),
                         ("commit", t3 - t2)):
            stage[busy][name].append(dt)
        stale += rc.stale_version_skipped
        per_batch.append((plan.embed_version, len(batch),
                          int(plan.hit.sum()),
                          sum(h and r != w for h, r, w in
                              zip(plan.hit, plan.responses, want)),
                          b >= REFRESH_BATCHES))
        tick(block=b >= REFRESH_BATCHES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    st = cache.stats_snapshot()
    rf = st.refresh
    plans = st.traffic["plans"]
    steps = sum(bx.get("fit", {}).get("steps", 0) for bx in boxes)
    launches = {k: clk.COUNTS[k] for k in ("contrastive_components",
                                           "contrastive_backward")}
    print(f"  {REFRESH_BATCHES * BATCH} queries with refreshes in "
          f"{serve_s:.2f} s, all {N_REQUESTS} in {wall:.2f} s; refreshes "
          f"started "
          f"{rf['refreshes_started']}, published "
          f"{rf['refreshes_published']}, rolled back "
          f"{rf['refreshes_rolled_back']}; embed version "
          f"{rf['embed_version']}; {rf['pairs_held']} pairs pooled")
    for n, bx in enumerate(boxes):
        g = bx.get("gate", {})
        f1 = (f"F1 candidate {g['candidate']['f1']:.4f} vs baseline "
              f"{g['baseline']['f1']:.4f} (AP {g['candidate']['ap']:.4f} "
              f"vs {g['baseline']['ap']:.4f})" if "candidate" in g
              else f"gate {g.get('reason')}")
        print(f"  refresh {n}: {bx.get('fit', {}).get('steps')} steps, "
              f"{bx.get('wall', 0.0):.2f} s on the thread; {f1}; "
              f"{'published' if g.get('pass') else 'rolled back'}")
    med = {busy: {k: 1e3 * statistics.median(v) if v else None
                  for k, v in d.items()} for busy, d in stage.items()}
    print(f"  plans served while a refresh was in flight {in_flight_plans} "
          f"of {plans}; stale-version commits {stale} (counter "
          f"{rf['stale_version_commits']}); publish stall ms "
          f"{[round(1e3 * s, 3) for s in stalls]} (join wait ms "
          f"{[round(1e3 * s, 3) for s in waits]}); recalibrated threshold "
          f"{rf['recalibrated_threshold']}")
    print(f"  stage p50 ms with a refresh in flight {med[True]}, without "
          f"{med[False]}")
    print(f"  published keys against the live encoder: max |diff| "
          f"{[round(e, 6) for e in key_errs]} (tolerance {KEY_ATOL}); "
          f"{len(evicted)} rows evicted mid-refresh, none valid after")
    out = {"launches": launches, "steps": steps, "plans": plans,
           "cascade_launches": ck.COUNTS["cascade_lookup"],
           "started": rf["refreshes_started"],
           "published": rf["refreshes_published"],
           "rolled_back": rf["refreshes_rolled_back"],
           "embed_version": rf["embed_version"],
           "in_flight_plans": in_flight_plans, "stale_commits": stale,
           "publish_stall_ms": [1e3 * s for s in stalls],
           "join_wait_ms": [1e3 * s for s in waits],
           "recalibrated_threshold": rf["recalibrated_threshold"],
           "key_max_abs_err": key_errs, "evicted": len(evicted),
           "stage_p50_ms": med, "wall_s": wall,
           "refreshes": [{"steps": bx.get("fit", {}).get("steps"),
                          "wall_s": bx.get("wall"),
                          "f1": bx.get("gate", {}).get("candidate", {})
                          .get("f1"),
                          "baseline_f1": bx.get("gate", {})
                          .get("baseline", {}).get("f1"),
                          "published": bool(bx.get("gate", {})
                                            .get("pass"))}
                         for bx in boxes]}
    # hit rate and false hits per hit of the plans served under each
    # embedder version; "first" is before the first publish, "last" the
    # trace's tail served after the closing join
    def segment(rows):
        q, h, f = (sum(r[j] for r in rows) for j in (1, 2, 3))
        return {"queries": q, "hit_rate": h / max(q, 1), "false_hits": f,
                "false_hit_share": f / max(h, 1)}
    out["by_version"] = {v: segment([r for r in per_batch if r[0] == v])
                         for v in sorted({r[0] for r in per_batch})}
    out["first"] = segment([r for r in per_batch if r[0] == 0])
    out["last"] = segment([r for r in per_batch if r[4]])
    print("  by embedder version: " + "; ".join(
        f"v{v}: {d['queries']} queries, hit rate {d['hit_rate']:.4f}, "
        f"false hits per hit {d['false_hit_share']:.4f}"
        for v, d in out["by_version"].items())
        + f"; before the first publish hit rate "
        f"{out['first']['hit_rate']:.4f}, false hits per hit "
        f"{out['first']['false_hit_share']:.4f}; the tail after the last "
        f"{out['last']['hit_rate']:.4f}, {out['last']['false_hit_share']:.4f}")
    print(f"  launches: cascade {out['cascade_launches']} for {plans} "
          f"plans; contrastive {launches} for {steps} candidate steps")
    if rf["refreshes_published"] < 1:
        fail("refresh: no refresh published")
    if launches != {"contrastive_components": steps,
                    "contrastive_backward": steps}:
        fail(f"refresh: contrastive launches {launches} for {steps} steps")
    if out["cascade_launches"] != plans:
        fail(f"refresh: cascade launched {out['cascade_launches']} times "
             f"for {plans} plans")
    if not evicted:
        fail("refresh: no refresh was in flight to evict tenant 1 under")
    return out


# ---------------------------------------------------------------------------
# phase 10: the MoE decoder answering cache misses
# ---------------------------------------------------------------------------

def moe_decoder_config():
    from repro_torch.configs import get_config
    cfg = get_config(MOE_DECODER)
    m = cfg.moe
    widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
              cfg.head_dim, m.num_experts, m.top_k, m.expert_d_ff,
              m.capacity_factor, cfg.vocab_size, cfg.dtype)
    if widths != (32, 1536, 24, 8, 64, 40, 8, 512, 1.25, 49155,
                  "bfloat16"):
        fail(f"{MOE_DECODER} is not at its published widths: {widths}")
    return cfg


def moe_dropped(lm) -> list:
    """Assignments past capacity in each MoE layer's last call."""
    return [int(blk.moe.dropped) for blk in lm.layers if hasattr(blk, "moe")]


def moe_generation_phase(dev, cfg) -> dict:
    """(a) 32 greedy tokens for 8 prompts through ``ServeEngine``."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    from repro_torch.models.moe import capacity_for
    from repro_torch.serving import ServeEngine
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"  {cfg.name}: {n_params:,} params (param_count() "
          f"{cfg.param_count():,}, {cfg.param_count(active_only=True):,} "
          f"active; float32 master weights, {cfg.dtype} activations), "
          f"built in {time.perf_counter() - t0:.1f} s")
    engine = ServeEngine(lm, max_len=GEN_PROMPT + GEN_NEW)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT)).astype(np.int32)
    engine.generate(prompts, 2)                         # warm
    torch.cuda.synchronize()
    attention_counts(reset=True)
    t0 = time.perf_counter()
    res = engine.generate(prompts, GEN_NEW)
    wall = time.perf_counter() - t0
    counts = attention_counts()
    L = cfg.n_layers
    if counts != {"flash_attention": L, "decode_attention": L * GEN_NEW}:
        fail(f"moe generate: launches {counts}, expected {L} flash (one "
             f"prefill) and {L * GEN_NEW} decode ({GEN_NEW} steps)")
    if res.tokens.shape != (GEN_B, GEN_NEW) or res.tokens.min() < 0 \
            or res.tokens.max() >= cfg.vocab_size:
        fail(f"moe generate: bad tokens {res.tokens.shape}")
    decode_dropped = moe_dropped(lm)        # the last step's, T = B = 8

    def prefill():
        out = lm.prefill(prompts, GEN_PROMPT + GEN_NEW)
        torch.cuda.synchronize()
        return out
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        prefill()
        times.append(time.perf_counter() - t1)
    prefill_dropped = moe_dropped(lm)
    prefill_ms = 1e3 * statistics.median(times)
    decode_ms = (1e3 * wall - prefill_ms) / GEN_NEW
    tok_s = GEN_B * GEN_NEW / wall
    peak = torch.cuda.max_memory_allocated() / 1e9
    T = GEN_B * GEN_PROMPT
    print(f"  generate: {GEN_B} x {GEN_NEW} tokens in {wall * 1e3:.1f} ms "
          f"({tok_s:.1f} tokens/s); prefill {prefill_ms:.3f} ms (B={GEN_B}, "
          f"S={GEN_PROMPT}), decode {decode_ms:.3f} ms per step; launches "
          f"{counts}; peak device memory {peak:.2f} GB; first row "
          f"{res.tokens[0, :8].tolist()}")
    print(f"  dropped assignments per layer at prefill (T={T}, "
          f"{T * cfg.moe.top_k} assignments, capacity "
          f"{capacity_for(cfg, T)} per expert): {prefill_dropped} (total "
          f"{sum(prefill_dropped)}); at a decode step (T={GEN_B}, capacity "
          f"{capacity_for(cfg, GEN_B)}): total {sum(decode_dropped)}")
    _, state = prefill()
    tok = torch.as_tensor(res.tokens[:, :1], device=dev)
    prof = profile(lambda: lm.decode_step(state, tok), "MoE decode step")
    casts = sum(ms for k, ms in prof["kernel_ms"].items() if "copy" in k)
    print(f"  weight casts (copy kernels) {casts:.3f} ms of the step's "
          f"{prof['device_ms']:.3f} ms of device time")
    return {"lm": lm, "engine": engine, "launches": counts,
            "tokens": res.tokens, "prompts": prompts,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tokens_per_s": tok_s, "generate_ms": wall * 1e3,
            "peak_gb": peak, "prefill_dropped": prefill_dropped,
            "decode_dropped": sum(decode_dropped), "profile": prof,
            "cast_ms": casts, "params": n_params}


class plain_attention:
    """Within the block the decoder's attention runs the plain torch
    versions on the card instead of the kernels (10(b)'s yardstick), with
    the kernels' arguments (the bf16-accumulate mode and its branch)."""

    def __enter__(self):
        from types import SimpleNamespace

        import torch
        from repro_torch.kernels.decode_attention import ref as dref
        from repro_torch.kernels.flash_attention import ref as fref
        from repro_torch.models import attention
        self.saved = attention.flash_ops, attention.decode_ops

        def flash(q, k, v, *, causal=True, window=0, scale=None,
                  acc_bf16=False, kv_chunk=None):
            return fref.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=causal, window=window, scale=scale,
                acc_dtype=torch.bfloat16 if acc_bf16 else torch.float32,
                kv_chunk=kv_chunk).transpose(1, 2)

        def decode(q, k, v, valid, *, scale=None):
            return dref.decode_attention(q[:, 0], k, v, valid,
                                         scale=scale)[:, None]
        attention.flash_ops = SimpleNamespace(flash_attention=flash)
        attention.decode_ops = SimpleNamespace(decode_attention=decode)

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.flash_ops, attention.decode_ops = self.saved


class record_routing:
    """Within the block every MoE call's top-k expert ids are kept, in
    call order (layer by layer, prefill then each decode step)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.real, calls = moe.MoE.route, []
        real = self.real

        def route(mod, xf, capacity):
            r = real(mod, xf, capacity)
            calls.append(r.expert_ids)
            return r
        moe.MoE.route = route
        return calls

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.MoE.route = self.real


def routing_flips(a_ids, b_ids) -> int:
    """Token-layer decisions whose top-k expert *sets* differ between two
    recorded runs (the order inside a set does not change the output)."""
    return sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
               for a, b in zip(a_ids, b_ids))


def moe_teacher_forced(lm, prompts, toks, steps: int):
    """Prefill logits and ``steps`` teacher-forced decode steps' logits,
    (1 + steps, B, vocab) float32."""
    import torch
    logits, state = lm.prefill(prompts, GEN_PROMPT + GEN_NEW)
    out = [logits.float()]
    for t in range(steps):
        logits, state = lm.decode_step(state, toks[:, t:t + 1])
        out.append(logits.float())
    return torch.stack(out)


def moe_plain_phase(dev, gn, cfg) -> dict:
    """(b) The prompts and (a)'s tokens, teacher-forced: prefill and
    every decode step's logits through the kernels against the same
    model with the plain attention versions — in bf16 (the served
    dtype), with the router decisions that the two paths' roundings
    flip counted, and in float32 (the same weights), where no decision
    flips and the logits must agree within ``DECODE_ATOL``."""
    import torch
    from repro_torch.models import LM
    lm, prompts = gn["lm"], gn["prompts"]
    toks = torch.as_tensor(gn["tokens"], device=dev)
    L, steps = lm.cfg.n_layers, GEN_NEW - 1
    attention_counts(reset=True)
    with record_routing() as k_ids:
        kern = moe_teacher_forced(lm, prompts, toks, steps)
    counts = attention_counts()
    attention_counts(reset=True)
    with plain_attention(), record_routing() as p_ids:
        plain = moe_teacher_forced(lm, prompts, toks, steps)
    if attention_counts() != {"flash_attention": 0, "decode_attention": 0}:
        fail("moe plain path: a kernel launched")
    if counts != {"flash_attention": L, "decode_attention": L * steps}:
        fail(f"moe kernel path: launches {counts}")
    flips, decisions = routing_flips(k_ids, p_ids), sum(
        a.shape[0] for a in k_ids)
    err = (kern - plain).abs()
    mean = float(err.mean())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    per_pos = [float(e) for e in err.amax(dim=(1, 2))]
    print(f"  bf16, kernels vs plain attention (teacher-forced, prefill + "
          f"{steps} steps): mean |dlogit| {mean:.4g} (tolerance "
          f"{MOE_BF16_MEAN_TOL}), argmax equal at {agree:.4f} of rows "
          f"(tolerance {MOE_BF16_AGREE}); max |dlogit| {max(per_pos):.4g} "
          f"(prefill {per_pos[0]:.4g}, logits up to "
          f"{float(plain.abs().max()):.3f}); router top-{cfg.moe.top_k} "
          f"sets differing in {flips} of {decisions} token-layer decisions")
    if not torch.isfinite(kern).all() or mean > MOE_BF16_MEAN_TOL \
            or agree < MOE_BF16_AGREE:
        fail(f"moe bf16: kernel logits off the plain path's: mean "
             f"|dlogit| {mean:.4g}, argmax equal at {agree:.4f}")
    del kern, plain
    lm32 = LM(cfg.replace(dtype="float32"), seed=0, device=dev)
    attention_counts(reset=True)
    with record_routing() as k_ids:
        kern = moe_teacher_forced(lm32, prompts, toks, MOE_FP32_STEPS)
    counts = attention_counts()
    with plain_attention(), record_routing() as p_ids:
        plain = moe_teacher_forced(lm32, prompts, toks, MOE_FP32_STEPS)
    del lm32
    if counts != {"flash_attention": L,
                  "decode_attention": L * MOE_FP32_STEPS}:
        fail(f"moe fp32 kernel path: launches {counts}")
    flips32 = routing_flips(k_ids, p_ids)
    err32 = float((kern - plain).abs().max())
    print(f"  float32, the same weights (prefill + {MOE_FP32_STEPS} "
          f"steps): max |dlogit| {err32:.3g} (tolerance {DECODE_ATOL}); "
          f"router sets differing in {flips32} decisions")
    if not err32 <= DECODE_ATOL:
        fail(f"moe fp32: kernel logits off the plain path's by "
             f"{err32:.3g} > {DECODE_ATOL}")
    return {"max_abs_err": max(per_pos), "per_position": per_pos,
            "mean_abs_err": mean, "argmax_agree": agree,
            "router_flips": flips, "router_decisions": decisions,
            "fp32_max_abs_err": err32, "fp32_router_flips": flips32}


# ---------------------------------------------------------------------------
# phase 11: the rest of the decoder zoo
# ---------------------------------------------------------------------------

def zoo_config(name: str):
    """The published config (Jamba cut to ``JAMBA_POSITIONS`` layers),
    its widths checked."""
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if name == JAMBA:
        cfg = cfg.replace(n_layers=JAMBA_POSITIONS,
                          period=cfg.period[:JAMBA_POSITIONS])
    head = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype,
            cfg.param_dtype, cfg.frontend_len if cfg.frontend else 0)
    want = {"xlstm-125m": (12, 768, 4, 4, 192, 0, 50304, "bfloat16",
                           "float32", 0),
            JAMBA: (5, 8192, 64, 8, 128, 24576, 65536, "bfloat16",
                    "bfloat16", 0),
            "musicgen-large": (48, 2048, 32, 32, 64, 8192, 2048, "bfloat16",
                               "float32", 256),
            "pixtral-12b": (40, 5120, 32, 8, 128, 14336, 131072,
                            "bfloat16", "float32", 256)}[name]
    extra = {"xlstm-125m": lambda c: c.tie_embeddings and not c.use_rope,
             JAMBA: lambda c: (c.moe.num_experts, c.moe.top_k,
                               c.moe.expert_d_ff, c.ssm.d_state,
                               c.ssm.d_conv, c.ssm.expand) == (
                                   16, 2, 24576, 16, 4, 2)
             and not c.use_rope,
             "musicgen-large": lambda c: not c.use_rope
             and c.family == "audio",
             "pixtral-12b": lambda c: c.use_rope}[name]
    if head != want or not extra(cfg):
        fail(f"{name} is not at its published widths: {head}")
    return cfg


def zoo_generation_phase(dev, cfg) -> dict:
    """7(a)'s generation (8 prompts of 32 tokens, 32 greedy tokens),
    behind the frontend stub's frames where the config has a frontend."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.frontend import stub_frontend_embeds
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    use_fe = bool(cfg.frontend)
    n_fe = cfg.frontend_len if use_fe else 0
    L = attention_layers(cfg)
    print(f"  {cfg.name}: {cfg.n_layers} layers ({L} attention), "
          f"{n_params:,} params ({cfg.param_dtype}; param_count() "
          f"{cfg.param_count():,}), {cfg.dtype} activations"
          + (f", {n_fe} {cfg.frontend} frontend frames" if use_fe else "")
          + f"; built in {time.perf_counter() - t0:.1f} s")
    max_len = n_fe + GEN_PROMPT + GEN_NEW
    engine = ServeEngine(lm, max_len=max_len)
    prompts = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (GEN_B, GEN_PROMPT)).astype(np.int32)
    engine.generate(prompts, 2, use_frontend=use_fe)        # warm
    torch.cuda.synchronize()
    attention_counts(reset=True)
    t0 = time.perf_counter()
    res = engine.generate(prompts, GEN_NEW, use_frontend=use_fe)
    wall = time.perf_counter() - t0
    counts = attention_counts()
    if counts != {"flash_attention": L, "decode_attention": L * GEN_NEW}:
        fail(f"{cfg.name} generate: launches {counts}, expected {L} flash "
             f"(one prefill) and {L * GEN_NEW} decode ({GEN_NEW} steps)")
    if res.tokens.shape != (GEN_B, GEN_NEW) or res.tokens.min() < 0 \
            or res.tokens.max() >= cfg.vocab_size:
        fail(f"{cfg.name} generate: bad tokens {res.tokens.shape}")
    fe = stub_frontend_embeds(cfg, GEN_B, 0, device=dev) if use_fe else None

    def prefill():
        out = lm.prefill(prompts, max_len, frontend_embeds=fe)
        torch.cuda.synchronize()
        return out
    times = []
    for _ in range(5):
        t1 = time.perf_counter()
        prefill()
        times.append(time.perf_counter() - t1)
    prefill_ms = 1e3 * statistics.median(times)
    decode_ms = (1e3 * wall - prefill_ms) / GEN_NEW
    tok_s = GEN_B * GEN_NEW / wall
    dropped = moe_dropped(lm)
    _, state = prefill()
    tok = torch.as_tensor(res.tokens[:, :1], device=dev)
    prof = profile(lambda: lm.decode_step(state, tok),
                   f"{cfg.name} decode step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"  generate: {GEN_B} x {GEN_NEW} tokens in {wall * 1e3:.1f} ms "
          f"({tok_s:.1f} tokens/s); prefill {prefill_ms:.3f} ms (B={GEN_B}, "
          f"S={n_fe}+{GEN_PROMPT}), decode {decode_ms:.3f} ms per step, "
          f"{prof['launches']} device launches per step; attention "
          f"launches {counts}; peak device memory {peak:.2f} GB; first row "
          f"{res.tokens[0, :8].tolist()}"
          + (f"; dropped MoE assignments per MoE layer at prefill "
             f"(T={GEN_B * (n_fe + GEN_PROMPT)}): {dropped}" if dropped
             else ""))
    return {"lm": lm, "engine": engine, "launches": counts,
            "params": n_params, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "tokens_per_s": tok_s,
            "generate_ms": wall * 1e3, "peak_gb": peak,
            "step_launches": prof["launches"],
            "step_device_ms": prof["device_ms"],
            "step_idle_share": prof["idle_share"],
            "prefill_dropped": dropped}


def zoo_decode_forward_phase(dev, cfg) -> dict:
    """(b) The same seed with float32 activations: teacher-forced decode logits against
    ``forward_lm`` at every position after a 32-token prompt, behind the
    frontend frames where the config has them."""
    import numpy as np
    import torch
    from repro_torch.models import LM
    from repro_torch.serving.frontend import stub_frontend_embeds
    cfg32 = cfg.replace(dtype="float32")
    if cfg.moe is not None:
        # capacity = T: the full forward (T = 96) must drop no assignment
        # that a decode step (T = 2) keeps, as the reference's own
        # decode-versus-forward test runs its MoE configs without drops
        cfg32 = cfg32.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    lm = LM(cfg32, seed=0, device=dev)
    S, t0 = 48, 32
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, S)), device=dev)
    fe = stub_frontend_embeds(cfg32, 2, 0, device=dev)
    n_fe = 0 if fe is None else cfg.frontend_len
    attention_counts(reset=True)
    with torch.no_grad():
        full, _ = lm.forward_lm(toks, fe)
        if sum(moe_dropped(lm)):
            fail(f"{cfg.name} forward_lm dropped MoE assignments: "
                 f"{moe_dropped(lm)}")
        logits, state = lm.prefill(toks[:, :t0], n_fe + S, fe)
        rows = [(logits, full[:, n_fe + t0 - 1])]
        for t in range(t0, S):
            logits, state = lm.decode_step(state, toks[:, t:t + 1])
            rows.append((logits, full[:, n_fe + t]))
    counts = attention_counts()
    errs = [float((a - b).abs().max()) for a, b in rows]
    agree = [bool(torch.equal(a.argmax(-1), b.argmax(-1))) for a, b in rows]
    L = attention_layers(cfg32)
    print(f"  {cfg.name}, float32"
          + (f", MoE capacity factor {cfg32.moe.capacity_factor:g} (no "
             "drops)" if cfg.moe is not None else "")
          + ": decode vs "
          f"forward_lm over {len(errs)} positions: max |dlogit| "
          f"{max(errs):.3g} (logits up to {float(full.abs().max()):.3f}); "
          f"argmax equal at {sum(agree)} of {len(agree)}; launches {counts}")
    if not max(errs) <= DECODE_ATOL or not all(agree):
        fail(f"{cfg.name} decode vs forward_lm: max |dlogit| "
             f"{max(errs):.3g} (bound {DECODE_ATOL}), argmax equal at "
             f"{sum(agree)} of {len(agree)}")
    if counts != {"flash_attention": 2 * L,
                  "decode_attention": (S - t0) * L}:
        fail(f"{cfg.name} decode vs forward_lm: launches {counts}")
    del lm, full, state
    return {"max_abs_err": max(errs), "positions": len(errs)}


def free_cuda() -> None:
    """Collect the freed models and hand their blocks back to the card."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def zoo_phase(dev, trainer, tok, ref_serving) -> dict:
    """Phase 11: each model's generation and 11(b) in turn, 11(c) with
    the xLSTM decoder; every model freed before the next."""
    out = {}
    for name in ZOO:
        t0 = time.perf_counter()
        cfg = zoo_config(name)
        tag = {"xlstm-125m": "a", JAMBA: "d", "musicgen-large": "e",
               "pixtral-12b": "f"}[name]
        print(f"  ({tag}) {name}: generation through ServeEngine")
        gn = zoo_generation_phase(dev, cfg)
        row = {k: v for k, v in gn.items() if k not in ("lm", "engine")}
        if name == "xlstm-125m":
            print("  (c) CachedLLMService: tuned encoder, tiered cache, "
                  "xLSTM decoder")
            ls = llm_serving_phase(dev, gn["engine"], trainer, tok)
            if (ls["hits"], ls["misses"]) != (ref_serving["hits"],
                                              ref_serving["misses"]):
                fail(f"xlstm llm serving: hits / misses {ls['hits']} / "
                     f"{ls['misses']}, phase 7(c) {ref_serving['hits']} / "
                     f"{ref_serving['misses']}")
            row["llm"] = {k: v for k, v in ls.items()}
        del gn
        free_cuda()
        print(f"  (b) {name}: float32 decode against forward_lm")
        row["decode_vs_forward"] = zoo_decode_forward_phase(dev, cfg)
        free_cuda()
        row["wall_s"] = time.perf_counter() - t0
        print(f"  {name} in {row['wall_s']:.1f} s")
        out[name] = row
    return out


# ---------------------------------------------------------------------------
# phase 12: decoder training
# ---------------------------------------------------------------------------

def train_steps(dev, lm, what: str, **kw) -> dict:
    """``launch/train.py``'s loop on ``lm`` (AdamW under the launcher's
    warm-up cosine, clip 1.0), each step's metrics and ms printed; fails
    on a non-finite loss or grad norm or an attention kernel launch
    (training attention is plain torch under autograd)."""
    import torch
    from repro_torch.launch import train as launch_train
    torch.cuda.synchronize()
    attention_counts(reset=True)
    run = launch_train.train(lm, lr=3e-4, log=lambda _: None, **kw)
    counts = attention_counts()
    for i, (m, ms) in enumerate(zip(run["history"], run["step_ms"])):
        print(f"    {what} step {i}: loss {m['loss']:.4f} (nll "
              f"{m['nll']:.4f}, aux {m['aux']:.4g}), grad_norm "
              f"{m['grad_norm']:.4f}, lr {m['lr']:.3e}, {ms:.1f} ms")
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm",
                                                  "aux")):
            fail(f"{what} training step {i}: non-finite metrics {m}")
    if any(counts.values()):
        fail(f"{what} training launched attention kernels {counts}: the "
             "train path must be plain attention under autograd")
    print(f"    {what}: {run['tokens_per_s']:.1f} tokens/s over "
          f"{len(run['step_ms'])} steps (first step included), peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return run


def zero_grads(lm) -> list:
    """Parameters whose gradient after the last step is None or all
    zero."""
    return [n for n, p in lm.named_parameters()
            if p.grad is None or not bool(p.grad.any())]


def kernel_nll(lm, tokens) -> float:
    """Mean next-token NLL from ``forward_lm``'s logits (the flash
    kernel), in float32."""
    import torch
    import torch.nn.functional as F
    with torch.no_grad():
        logits, _ = lm.forward_lm(tokens)
        V = logits.shape[-1]
        return float(F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                                     tokens[:, 1:].long().reshape(-1)))


def train_tokens(dev, cfg, B: int, S: int, seed: int):
    import numpy as np
    import torch
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32), device=dev)


def optimizer_ms(lm, update, opt) -> float:
    """One in-place AdamW update (clip, moments, parameters) on the
    last step's gradients, host wall to the device's end."""
    import torch
    params = dict(lm.named_parameters())
    grads = {n: p.grad for n, p in params.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    update.in_place(grads, opt, params)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    print(f"    one in-place AdamW update over {len(params)} tensors: "
          f"{ms:.1f} ms")
    return ms


def flash_against_training_attention(dev, lm) -> float:
    """Layer 0's attention at S = TRAIN_S: the flash kernel (serving)
    against the plain ``gqa_attention`` that training takes (its chunked
    branch at this length) on the same q, k, v, elementwise within
    ``ATTN_TOL`` of the model's dtype.  Returns the max |diff|.  The
    kernel's launches here are a comparison and are not counted."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import layers
    from repro_torch.models.attention import gqa_attention
    cfg = lm.cfg
    attn = lm.layers[0].attn
    pos = torch.arange(TRAIN_S, device=dev)
    sin, cos = layers.rope_frequencies(cfg, pos)
    x = torch.randn(TRAIN_B, TRAIN_S, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6)
                    ).to(getattr(torch, cfg.dtype))
    with torch.no_grad():
        q, k, v = attn._qkv(x, sin, cos)
        plain = gqa_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True,
                              window=cfg.sliding_window)
        kern = flash_ops.flash_attention(attn._scaled(q), k, v, causal=True,
                                         window=cfg.sliding_window,
                                         scale=1.0)
    tol = ATTN_TOL[cfg.dtype]
    a, b = plain.float(), kern.float()
    err = float((a - b).abs().max())
    ok = bool(((a - b).abs() <= tol["atol"] + tol["rtol"] * a.abs()).all())
    print(f"    {cfg.dtype} layer 0 at S={TRAIN_S}: flash kernel against "
          f"the chunked training attention, max |diff| {err:.3g} "
          f"(atol {tol['atol']}, rtol {tol['rtol']})")
    if not ok:
        fail(f"12(b) {cfg.dtype}: the flash kernel and the training "
             f"attention differ (max |diff| {err:.3g})")
    return err


def train_attention_ms(dev, lm, reps: int = 3) -> dict:
    """The training attention of one layer at S = TRAIN_S: the plain
    ``gqa_attention`` (the chunked branch) forward + backward on layer
    0's q, k, v against ``F.scaled_dot_product_attention`` (causal, the
    library yardstick, never on the port's path) on the same tensors."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import layers
    from repro_torch.models.attention import gqa_attention
    cfg = lm.cfg
    attn = lm.layers[0].attn
    x = torch.randn(TRAIN_B, TRAIN_S, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5)
                    ).to(getattr(torch, cfg.dtype))
    pos = torch.arange(TRAIN_S, device=dev)
    sin, cos = layers.rope_frequencies(cfg, pos)
    with torch.no_grad():
        q, k, v = (t.detach() for t in attn._qkv(x, sin, cos))
    ct = torch.randn_like(q)

    def plain():
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = gqa_attention(ts[0], ts[1], ts[2], q_pos=pos, kv_pos=pos,
                          causal=True, window=0)
        torch.autograd.grad(o, ts, ct)

    def library():
        ts = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
        o = F.scaled_dot_product_attention(*ts, is_causal=True)
        torch.autograd.grad(o, ts, ct.transpose(1, 2))

    out = {}
    for name, fn in (("plain", plain), ("library", library)):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[f"{name}_ms"] = statistics.median(times)
    print(f"    one layer's attention forward + backward at S={TRAIN_S}: "
          f"plain (chunked, float32) {out['plain_ms']:.2f} ms, SDPA "
          f"(bf16, causal) {out['library_ms']:.2f} ms")
    return out


def decoder_training_phase(dev) -> dict:
    """(a) full-width Phi-3-mini trained at S = 4096, then on one fixed
    batch; (b) its ``lm_loss`` against the flash kernel's NLL, and a
    float32 copy cut to 4 layers."""
    import torch
    from repro_torch.models import LM
    from repro_torch.training import adamw, constant, make_train_step
    cfg = decoder_config()
    if not cfg.remat or cfg.param_dtype != "float32":
        fail(f"{cfg.name}: remat {cfg.remat}, params {cfg.param_dtype}")
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"  (a) {cfg.name}: {n_params:,} {cfg.param_dtype} params, "
          f"{cfg.dtype} activations, remat on, B={TRAIN_B} S={TRAIN_S}; "
          "built in "
          f"{time.perf_counter() - t0:.1f} s")
    run = train_steps(dev, lm, "phi3", steps=TRAIN_STEPS, batch=TRAIN_B,
                      seq=TRAIN_S)
    out = {"params": n_params, "step_ms": run["step_ms"],
           "tokens_per_s": run["tokens_per_s"],
           "history": run["history"]}
    zero = zero_grads(lm)
    if zero:
        fail(f"phi3 training: {len(zero)} parameters with no or an all-"
             f"zero gradient, e.g. {zero[:6]}")
    n_qkv = sum(n.split(".")[-1] in ("wq", "wk", "wv") and ".attn." in n
                for n, _ in lm.named_parameters())
    print(f"    every parameter has a nonzero gradient ({n_qkv} attention "
          "wq/wk/wv among them)")
    # the fixed batch: the same optimizer state, a constant lr; the last
    # two steps run under profile(), the second of them traced
    _, update = adamw(constant(TRAIN_FIXED_LR), max_grad_norm=1.0)
    step = make_train_step(lm, update)
    batch = {"tokens": train_tokens(dev, cfg, TRAIN_B, TRAIN_S, 21)}
    state = {"opt": run["opt"], "losses": []}
    del run

    def fixed_step():
        state["opt"], m = step(state["opt"], batch)
        state["losses"].append(float(m["loss"]))

    fixed_step()
    prof = profile(fixed_step, "train step (phi3, S=4096)")
    losses = state["losses"]
    print(f"    fixed batch at lr {TRAIN_FIXED_LR}: losses "
          + ", ".join(f"{x:.5f}" for x in losses))
    if len(losses) != TRAIN_FIXED_STEPS or not losses[-1] < losses[0]:
        fail(f"phi3 training: the fixed batch's loss did not fall: "
             f"{losses}")
    out.update(fixed_losses=losses, peak_gb=torch.cuda.max_memory_allocated()
               / 1e9, profile={k: prof[k] for k in (
                   "wall_ms", "device_ms", "idle_share", "launches")},
               top_kernels_ms=dict(sorted(
                   prof["kernel_ms"].items(), key=lambda kv: -kv[1])[:8]))
    print(f"    peak device memory {out['peak_gb']:.2f} GB "
          f"(torch.cuda.max_memory_allocated)")
    out["optimizer_ms"] = optimizer_ms(lm, update, state["opt"])
    out["attention"] = train_attention_ms(dev, lm)
    del state
    for p in lm.parameters():
        p.grad = None
    free_cuda()

    print("  (b) lm_loss (plain chunked attention) against forward_lm's NLL "
          "(the flash kernel)")
    attn_err = flash_against_training_attention(dev, lm)
    toks = train_tokens(dev, cfg, TRAIN_B, TRAIN_S, 22)
    attention_counts(reset=True)
    with torch.no_grad():
        plain = float(lm.lm_loss(toks)[1]["nll"])
    nll_k = kernel_nll(lm, toks)
    counts = attention_counts()
    if counts["flash_attention"] != attention_layers(cfg):
        fail(f"12(b) forward_lm: flash launches {counts}")
    err = abs(plain - nll_k)
    print(f"    bf16 S={TRAIN_S}: lm_loss nll {plain:.6f}, kernel "
          f"{nll_k:.6f}, |diff| {err:.3g} (bound {TRAIN_BF16_ATOL})")
    if not err <= TRAIN_BF16_ATOL:
        fail(f"12(b) bf16: |lm_loss - kernel nll| {err:.3g}")
    out["bf16_nll"] = {"plain": plain, "kernel": nll_k, "abs_err": err,
                       "attention_max_abs_err": attn_err}
    del lm
    free_cuda()
    f32 = LM(cfg.replace(n_layers=TRAIN_FP32_LAYERS, dtype="float32"),
             seed=0, device=dev)
    attn_err = flash_against_training_attention(dev, f32)
    with torch.no_grad():
        plain = float(f32.lm_loss(toks)[1]["nll"])
    nll_k = kernel_nll(f32, toks)
    rel = abs(plain - nll_k) / abs(nll_k)
    print(f"    float32, {TRAIN_FP32_LAYERS} layers: lm_loss nll "
          f"{plain:.7f}, kernel {nll_k:.7f}, relative diff {rel:.3g} "
          f"(bound {TRAIN_FP32_RTOL})")
    if not rel <= TRAIN_FP32_RTOL:
        fail(f"12(b) float32: relative |lm_loss - kernel nll| {rel:.3g}")
    out["fp32_nll"] = {"plain": plain, "kernel": nll_k, "rel_err": rel,
                       "attention_max_abs_err": attn_err}
    del f32
    free_cuda()
    return out


def other_training_phase(dev) -> dict:
    """(c) full-width Granite-MoE and (d) xLSTM-125M through the
    launcher's loop."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    out = {}
    for tag, name, kw in (("c", MOE_DECODER, MOE_TRAIN),
                          ("d", "xlstm-125m", XLSTM_TRAIN)):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(name)
        lm = LM(cfg, seed=0, device=dev)
        n_params = sum(p.numel() for p in lm.parameters())
        print(f"  ({tag}) {name}: {n_params:,} params, B={kw['batch']} "
              f"S={kw['seq']}")
        run = train_steps(dev, lm, name.split("-")[0], **kw)
        row = {"params": n_params, "step_ms": run["step_ms"],
               "tokens_per_s": run["tokens_per_s"],
               "history": run["history"],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        if cfg.moe is not None:
            auxes = [m["aux"] for m in run["history"]]
            router = [p.grad for n, p in lm.named_parameters()
                      if n.endswith("moe.router")]
            if not all(a > 0 for a in auxes):
                fail(f"{name} training: aux {auxes} not all > 0")
            if not router or not all(g is not None and bool(g.any())
                                     for g in router):
                fail(f"{name} training: a router has no gradient")
            print(f"    aux {auxes}; all {len(router)} routers have "
                  "nonzero gradients")
        zero = zero_grads(lm)
        if zero:
            fail(f"{name} training: parameters with no or an all-zero "
                 f"gradient, e.g. {zero[:6]}")
        out[name] = row
        del lm, run
    free_cuda()
    return out


# ---------------------------------------------------------------------------
# phase 13: the sharded warm tier
# ---------------------------------------------------------------------------

def sharded_states(dev, S: int, indexed_only: bool = False, seed: int = 7):
    """Phase 2's tiers with the warm ring split into S shards: the hot
    tier and the query batch as `build_states` makes them, the 16384
    warm rows round-robin over S rings of 16384 / S rows with 64 / S
    local clusters each (flushes of 256 rows, the ring wrapped, a
    per-shard rebuild, an unindexed tail of 50 rows per shard unless
    ``indexed_only``, 10 % invalid rows)."""
    import torch
    from repro_torch.cache_service import tiers
    s = SHAPES
    D, Nh, cap = s["D"], s["Nh"], s["cap"] // S
    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(x):
        return x / x.norm(dim=-1, keepdim=True)

    centres = unit(torch.randn(512, D, generator=g, device=dev))

    def rows(n, noise=0.03):
        c = torch.randint(0, 512, (n,), generator=g, device=dev)
        return unit(centres[c] + noise * torch.randn(n, D, generator=g,
                                                     device=dev))

    def tenants(n):
        return torch.randint(0, 4, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    hot = tiers.init_hot(Nh, D, dev)
    hot, _ = tiers.hot_insert_batch(
        hot, rows(Nh), torch.arange(Nh, device=dev, dtype=torch.int32),
        tenants(Nh))
    hot = hot._replace(valid=hot.valid & (torch.rand(
        Nh, generator=g, device=dev) > 0.2))
    warm = tiers.init_warm_sharded(S, cap, D, s["K"] // S, s["bucket"], dev)
    vid = 10_000

    def append(warm, n):
        nonlocal vid
        dem = tiers.Demoted(
            keys=rows(n), tenants=tenants(n),
            value_ids=torch.arange(vid, vid + n, device=dev,
                                   dtype=torch.int32),
            mask=torch.ones(n, dtype=torch.bool, device=dev))
        vid += n
        return tiers.warm_append_sharded(warm, dem)[0]

    for _ in range((s["cap"] + 4096) // 256):         # wraps every ring
        warm = append(warm, 256)
    if indexed_only:
        warm = tiers.warm_rebuild_sharded(append(warm, 200), 4, seed)
    else:
        warm = append(tiers.warm_rebuild_sharded(warm, 4, seed), 200)
    warm = warm._replace(valid=warm.valid & (torch.rand(
        warm.valid.shape, generator=g, device=dev) > 0.1))
    Q = s["Q"]
    flat_keys, flat_valid = warm.keys.reshape(-1, D), warm.valid.reshape(-1)
    flat_ten = warm.tenants.reshape(-1)
    live_w = torch.nonzero(flat_valid).squeeze(1)
    src_w = live_w[torch.randint(0, len(live_w), (Q // 2,), generator=g,
                                 device=dev)]
    live_h = torch.nonzero(hot.valid).squeeze(1)
    src_h = live_h[torch.randint(0, len(live_h), (Q // 4,), generator=g,
                                 device=dev)]
    n_new = Q - len(src_w) - len(src_h)
    q = torch.cat([flat_keys[src_w], hot.keys[src_h], rows(n_new)])
    q = unit(q + 0.015 * torch.randn(Q, D, generator=g, device=dev))
    qt = torch.cat([flat_ten[src_w], hot.tenants[src_h], tenants(n_new)])
    thr = 0.6 + 0.35 * torch.rand(Q, generator=g, device=dev)
    return hot, tiers.requantize(warm), q.contiguous(), qt, thr


def unsharded_view(swarm):
    """The S shards of an all-indexed stacked ring as ONE ring of S x cap
    rows whose IVF is the shards' lists side by side (row ids offset by
    shard), every row indexed: probing all of its S x K lists scores
    exactly the rows the S shards' full probes score."""
    import torch
    from repro_torch.cache_service import tiers
    S, cap = swarm.valid.shape
    off = (torch.arange(S, device=swarm.members.device, dtype=torch.int32)
           * cap)[:, None, None]
    members = torch.where(swarm.members >= 0, swarm.members + off, -1)
    top = swarm.total.max()
    return tiers.WarmState(
        keys=swarm.keys.reshape(S * cap, -1), valid=swarm.valid.reshape(-1),
        tenants=swarm.tenants.reshape(-1),
        value_ids=swarm.value_ids.reshape(-1),
        write_seq=swarm.write_seq.reshape(-1), cursor=swarm.cursor[0],
        total=swarm.total.sum().to(torch.int32),
        centroids=swarm.centroids.reshape(
            -1, swarm.centroids.shape[-1]),
        members=members.reshape(-1, swarm.members.shape[-1]),
        sizes=swarm.sizes.reshape(-1), indexed_total=top,
        keys_q=swarm.keys_q.reshape(S * cap, -1),
        scales=swarm.scales.reshape(-1),
        expires_at=swarm.expires_at.reshape(-1))


def same_result(a, b, what: str, exact: bool = False) -> float:
    """Two lookup results: ints and flags equal, scores within
    SCORE_ATOL (or bit for bit); returns the max |score difference|."""
    import torch
    err = 0.0
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.shape != y.shape or x.dtype != y.dtype:
            fail(f"{what}: {name} {tuple(y.shape)}/{y.dtype} vs "
                 f"{tuple(x.shape)}/{x.dtype}")
        if x.dtype.is_floating_point and not exact:
            if not torch.isfinite(y[y > -1e29]).all():
                fail(f"{what}: non-finite {name}")
            err = max(err, float((x - y).abs().max()))
            if err > SCORE_ATOL:
                fail(f"{what}: max |{name} diff| {err:.3g} > {SCORE_ATOL}")
        elif not torch.equal(x, y):
            fail(f"{what}: {name} differs in {int((x != y).sum())} entries")
    return err


def sharded_stacked_phase(dev) -> dict:
    """13(a): the stacked form in this process at S = SHARDS, fp32 and
    int8; the per-shard kernels against their plain versions, the
    sharded full probe against the unsharded one, and the same for the
    E = 3 ensemble; the S = MESH_RANKS oracle for 13(b)."""
    import torch
    from repro_torch.cache_service import tiers
    from repro_torch.kernels.cascade_lookup import kernel, ops, ref
    s, S = SHAPES, SHARDS
    K = s["K"] // S
    kw = dict(k=1, n_probe=s["n_probe"], tail=s["tail"])
    hot, swarm, q, qt, thr = sharded_states(dev, S)
    ens, qe, w = ensemble_states(dev, hot, swarm, q)
    ens = ens._replace(warm_keys=ens.warm_keys.transpose(0, 1).contiguous(),
                       warm_keys_q=ens.warm_keys_q.transpose(0, 1)
                       .contiguous(),
                       warm_scales=ens.warm_scales.transpose(0, 1)
                       .contiguous())                   # (S, E, cap, ...)
    q_e = qe.transpose(0, 1).contiguous()               # (Q, E, D)
    out = {"shards": S, "rows_per_shard": s["cap"] // S,
           "clusters_per_shard": K, "max_abs_err": 0.0}
    print(f"  S={S} shards of {s['cap'] // S} rows, {K} local clusters, "
          f"bucket {s['bucket']}, n_probe {s['n_probe']}, tail "
          f"{s['tail']} per shard; hot {s['Nh']}; Q={s['Q']}, D={s['D']}")
    for quantized in (False, True):
        tag = "int8" if quantized else "fp32"
        for i in range(S):
            h = tiers._hot_on_shard(hot, i)
            w_i = tiers._shard(swarm, i)
            args = lookup_args(h, w_i, q, qt, thr)
            err = compare(ref.cascade_lookup(*args, quantized=quantized,
                                             **kw),
                          ops.cascade_lookup(*args, quantized=quantized,
                                             **kw),
                          f"shard {i} cascade {tag}")
            eargs = (qe, w, qt, thr, ens.hot_keys, h.valid, h.tenants,
                     h.value_ids, ens.warm_keys[i], w_i.valid, w_i.tenants,
                     w_i.value_ids, w_i.write_seq, w_i.centroids,
                     w_i.members, w_i.cursor, w_i.indexed_total,
                     ens.warm_keys_q[i], ens.warm_scales[i])
            err = max(err, compare(
                ref.ensemble_lookup(*eargs, quantized=quantized, **kw),
                ops.ensemble_lookup(*eargs, quantized=quantized, **kw),
                f"shard {i} ensemble {tag}"))
            out["max_abs_err"] = max(out["max_abs_err"], err)
        kernel.COUNTS.update(cascade_lookup=0, cascade_lookup_ensemble=0)
        res = tiers.cascade_query(hot, swarm, q, qt, thr, fused=True,
                                  quantized=quantized, **kw)
        eres = tiers.ensemble_cascade_query(hot, swarm, ens, q_e, w, qt, thr,
                                            fused=True, quantized=quantized,
                                            **kw)
        torch.cuda.synchronize()
        launches = dict(kernel.COUNTS)
        if launches != {"cascade_lookup": S, "cascade_lookup_ensemble": S}:
            fail(f"stacked sharded lookup ({tag}): launches {launches}, "
                 f"expected {S} of each")
        out[f"{tag}_launches_per_plan"] = launches
        out[f"{tag}_ms"] = cuda_ms(lambda: tiers.cascade_query(
            hot, swarm, q, qt, thr, fused=True, quantized=quantized, **kw))
        out[f"{tag}_ensemble_ms"] = cuda_ms(
            lambda: tiers.ensemble_cascade_query(
                hot, swarm, ens, q_e, w, qt, thr, fused=True,
                quantized=quantized, **kw))
        print(f"  {tag}: every shard's cascade and ensemble kernel equal to "
              f"ref.py (ints / flags exactly, scores within {SCORE_ATOL}); "
              f"launches per plan {launches}; hits {int(res.hit.sum())}/"
              f"{s['Q']} (hot {int(res.hot_hit.sum())}), ensemble hits "
              f"{int(eres.hit.sum())}; stacked lookup "
              f"{out[f'{tag}_ms']:.4f} ms, ensemble "
              f"{out[f'{tag}_ensemble_ms']:.4f} ms (eager, CUDA events)")
    # full probe: every indexed row of every shard against one ring of
    # the same rows and the same lists
    hot, swarm, q, qt, thr = sharded_states(dev, S, indexed_only=True)
    ens, qe, w = ensemble_states(dev, hot, swarm, q)
    flat = unsharded_view(swarm)
    fens = ens._replace(warm_keys=ens.warm_keys.reshape(ENS_E, -1, s["D"]),
                        warm_keys_q=ens.warm_keys_q.reshape(
                            ENS_E, -1, s["D"]),
                        warm_scales=ens.warm_scales.reshape(ENS_E, -1))
    sens = ens._replace(warm_keys=ens.warm_keys.transpose(0, 1).contiguous(),
                        warm_keys_q=ens.warm_keys_q.transpose(0, 1)
                        .contiguous(),
                        warm_scales=ens.warm_scales.transpose(0, 1)
                        .contiguous())
    q_e = qe.transpose(0, 1).contiguous()
    for k in (1, 4):
        a = tiers.cascade_query(hot, swarm, q, qt, thr, k=k, n_probe=K,
                                tail=s["tail"], fused=True)
        b = tiers.cascade_query(hot, flat, q, qt, thr, k=k, n_probe=S * K,
                                tail=s["tail"], fused=True)
        err = same_result(b, a, f"full probe sharded vs unsharded k={k}")
        ea = tiers.ensemble_cascade_query(hot, swarm, sens, q_e, w, qt, thr,
                                          k=k, n_probe=K, tail=s["tail"],
                                          fused=True)
        eb = tiers.ensemble_cascade_query(hot, flat, fens, q_e, w, qt, thr,
                                          k=k, n_probe=S * K,
                                          tail=s["tail"], fused=True)
        err = max(err, same_result(
            eb, ea, f"ensemble full probe sharded vs unsharded k={k}"))
        out["full_probe_max_abs_err"] = max(
            out.get("full_probe_max_abs_err", 0.0), err)
        print(f"  full probe, k={k}: sharded ({S} x {K} lists) equal to "
              f"unsharded ({S * K} lists) for the cascade and the E={ENS_E} "
              f"ensemble (fp32): ids, slots and flags exactly, max |dscore| "
              f"{err:.3g}; hits {int(a.hit.sum())}/{s['Q']}")
    return out


def mesh_oracle(dev, path: str) -> None:
    """The S = MESH_RANKS stacked state and its oracle results, saved to
    ``path`` for the ranks of 13(b)."""
    import torch
    from repro_torch.cache_service import tiers
    s = SHAPES
    kw = dict(k=1, n_probe=s["n_probe"], tail=s["tail"])
    hot, swarm, q, qt, thr = sharded_states(dev, MESH_RANKS)
    ens, qe, w = ensemble_states(dev, hot, swarm, q)
    ens = ens._replace(warm_keys=ens.warm_keys.transpose(0, 1).contiguous(),
                       warm_keys_q=ens.warm_keys_q.transpose(0, 1)
                       .contiguous(),
                       warm_scales=ens.warm_scales.transpose(0, 1)
                       .contiguous())
    q_e = qe.transpose(0, 1).contiguous()
    oracle = {}
    for quantized in (False, True):
        oracle[("cascade", quantized)] = tiers.cascade_query(
            hot, swarm, q, qt, thr, fused=True, quantized=quantized, **kw)
        oracle[("ensemble", quantized)] = tiers.ensemble_cascade_query(
            hot, swarm, ens, q_e, w, qt, thr, fused=True,
            quantized=quantized, **kw)
    torch.save({"hot": hot._asdict(), "swarm": swarm._asdict(),
                "ens": ens._asdict(), "q": q, "qt": qt, "thr": thr,
                "q_e": q_e, "w": w, "kw": kw,
                "oracle": {key: r._asdict() for key, r in oracle.items()}},
               path)


def mesh_rank_main(rank: int, workdir: str, device: str, out) -> None:
    """One rank of 13(b) / 13(c): a gloo group over a ``FileStore`` (two
    ranks on one card; NCCL takes one rank per device)."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        # the ranks share the host's cores with each other and the parent
        torch.set_num_threads(max(1, (os.cpu_count() or 2) // (
            2 * MESH_RANKS)))
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group(
            "gloo", init_method=f"file://{workdir}/store", rank=rank,
            world_size=MESH_RANKS)
        out.put((rank, True, mesh_rank_phase(rank, workdir, dev)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def mesh_rank_phase(rank: int, workdir: str, dev) -> dict:
    """13(b): this rank's `_cascade_sharded` / `_ensemble_sharded` against
    the stacked oracle, bit for bit; 13(c): the sharded CacheService over
    phase 3's trace (its keys), answers checked as phase 3's."""
    import numpy as np
    import torch
    from repro_torch.cache_service import (
        CacheConfig, CacheService, ShardingConfig, TieringConfig, tiers,
    )
    from repro_torch.kernels.cascade_lookup import kernel
    from repro_torch.launch.mesh import make_cache_mesh
    from repro_torch.obs import Telemetry
    mesh = make_cache_mesh(MESH_RANKS, device=dev.type)
    st = torch.load(f"{workdir}/state.pt", map_location=dev)
    kw = st["kw"]
    hot = tiers.HotState(**st["hot"])
    local = tiers.place_warm_sharded(tiers.WarmState(**st["swarm"]), mesh)
    ens = tiers.place_ensemble_sharded(tiers.EnsembleState(**st["ens"]),
                                       mesh)
    q, qt, thr, q_e, w = (st[k] for k in ("q", "qt", "thr", "q_e", "w"))
    out = {"rank": rank, "local_rows": int(local.valid.shape[1])}
    for quantized in (False, True):
        tag = "int8" if quantized else "fp32"
        for what in ("cascade", "ensemble"):
            def run():
                if what == "cascade":
                    return tiers.cascade_query(
                        hot, local, q, qt, thr, fused=True,
                        quantized=quantized, mesh=mesh, **kw)
                return tiers.ensemble_cascade_query(
                    hot, local, ens, q_e, w, qt, thr, fused=True,
                    quantized=quantized, mesh=mesh, **kw)
            kernel.COUNTS.update(cascade_lookup=0, cascade_lookup_ensemble=0)
            got = run()
            sync(dev)
            out[f"{what}_{tag}_launches"] = sum(kernel.COUNTS.values())
            want = type(got)(**st["oracle"][(what, quantized)])
            same_result(want, got, f"rank {rank} mesh {what} {tag} vs the "
                        "stacked oracle", exact=True)
            walls = []
            for _ in range(20):
                sync(dev)
                t0 = time.perf_counter()
                run()
                sync(dev)
                walls.append(1e3 * (time.perf_counter() - t0))
            out[f"{what}_{tag}_ms"] = statistics.median(walls)
    # 13(c): the sharded service on phase 3's trace
    texts = json.load(open(f"{workdir}/texts.json"))
    embs = list(np.load(f"{workdir}/embs.npy"))
    telemetry = Telemetry()
    cache = CacheService(CacheConfig(
        dim=embs[0].shape[1], threshold=THRESHOLD, telemetry=telemetry,
        tiering=TieringConfig(fused=True),
        sharding=ShardingConfig(mesh=mesh)), device=dev)
    kernel.COUNTS["cascade_lookup"] = 0
    t0 = time.perf_counter()
    served = drive_echo(cache, embs, texts)
    sync(dev)
    wall = time.perf_counter() - t0
    snap = cache.stats_snapshot()
    out.update(service_summary(cache, telemetry, served, wall))
    out["launches"] = kernel.COUNTS["cascade_lookup"]
    out["warm_shards"] = snap.tiers["warm_shards"]
    out["local_warm_rows"] = int(cache.warm.valid.sum())
    return out


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def service_summary(cache, telemetry, served, wall) -> dict:
    snap = cache.stats_snapshot()
    p50 = stage_hist_ms(telemetry, ("plan", "commit"))
    return {"hits": served["hits"], "misses": served["misses"],
            "value_ids": served["value_ids"].tolist(),
            "hit_rate": served["hits"] / (served["hits"] + served["misses"]),
            "plans": snap.traffic["plans"],
            "warm_hits": snap.traffic["warm_hits"],
            "demotions": snap.tiers["demotions"],
            "rebuilds": snap.rebuild["rebuilds"],
            "plan_p50_ms": p50["plan"][0], "commit_p50_ms": p50["commit"][0],
            "plan_mean_ms": p50["plan"][1],
            "commit_mean_ms": p50["commit"][1], "wall_s": wall}


def sharded_mesh_phase(dev, embs, texts) -> dict:
    """13(b) and 13(c) on MESH_RANKS ranks spawned on this card, after
    the unsharded service's run of (c) here for comparison."""
    import multiprocessing
    import queue
    import tempfile
    import numpy as np
    import torch
    from repro_torch.cache_service import (
        CacheConfig, CacheService, TieringConfig,
    )
    from repro_torch.obs import Telemetry
    telemetry = Telemetry()
    cache = CacheService(CacheConfig(
        dim=embs[0].shape[1], threshold=THRESHOLD, telemetry=telemetry,
        tiering=TieringConfig(fused=True)), device=dev)
    t0 = time.perf_counter()
    served = drive_echo(cache, embs, texts)
    sync(dev)
    single = service_summary(cache, telemetry, served,
                             time.perf_counter() - t0)
    del cache
    free_cuda()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        mesh_oracle(dev, f"{wd}/state.pt")
        np.save(f"{wd}/embs.npy", np.stack(embs))
        json.dump(texts, open(f"{wd}/texts.json", "w"))
        sync(dev)
        ctx = multiprocessing.get_context("spawn")
        q = ctx.Queue()
        where = f"cuda:{torch.cuda.current_device()}" \
            if dev.type == "cuda" else "cpu"
        procs = [ctx.Process(target=mesh_rank_main, args=(r, wd, where, q),
                             daemon=True) for r in range(MESH_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        ranks = {}
        try:
            for _ in procs:
                try:
                    r, ok, val = q.get(timeout=max(
                        MESH_TIMEOUT_S - (time.perf_counter() - t0), 1))
                except queue.Empty:
                    fail(f"13(b): ranks {sorted(set(range(MESH_RANKS)) - set(ranks))}"
                         f" did not report within {MESH_TIMEOUT_S} s")
                if not ok:
                    fail(f"13(b): rank {r} failed:\n{val}")
                ranks[r] = val
        finally:
            for p in procs:
                p.join(timeout=30)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        spawn_s = time.perf_counter() - t0
    ranks = [ranks[r] for r in range(MESH_RANKS)]
    for r in ranks:
        for key in ("cascade_fp32", "cascade_int8", "ensemble_fp32",
                    "ensemble_int8"):
            if r[f"{key}_launches"] != 1:
                fail(f"13(b) rank {r['rank']}: {key} launched "
                     f"{r[f'{key}_launches']} kernels for one plan")
        if r["warm_shards"] != MESH_RANKS:
            fail(f"13(c): warm_shards {r['warm_shards']}")
        if r["launches"] != r["plans"]:
            fail(f"13(c) rank {r['rank']}: {r['launches']} cascade launches "
                 f"for {r['plans']} plans")
        for key in ("hits", "value_ids", "plans", "demotions"):
            if r[key] != ranks[0][key]:
                fail(f"13(c): rank {r['rank']} {key} differs from rank 0's")
    print(f"  (b) {MESH_RANKS} ranks on one card (gloo, FileStore), "
          f"{spawn_s:.1f} s with start-up: every rank's cascade and "
          "ensemble (fp32, int8) equal to the stacked oracle bit for bit, "
          "one kernel launch per rank per plan; mesh lookup host wall "
          + ", ".join(f"{k} {ranks[0][f'{k}_ms']:.3f} ms" for k in (
              "cascade_fp32", "cascade_int8", "ensemble_fp32",
              "ensemble_int8")) + " (rank 0, median of 20, synced)")
    sh = ranks[0]
    both = [(a, b) for a, b in zip(single["value_ids"], sh["value_ids"])
            if a >= 0 and b >= 0]
    print(f"  (c) CacheService on {MESH_RANKS} shards over phase 3's "
          f"{len(texts)} queries: hits {sh['hits']} (warm {sh['warm_hits']}),"
          f" hit rate {sh['hit_rate']:.4f}; unsharded here {single['hits']} "
          f"(warm {single['warm_hits']}), hit rate "
          f"{single['hit_rate']:.4f}; {len(both)} queries hit by both, each "
          f"answered with its own text; plan p50 {sh['plan_p50_ms']:.3f} ms"
          f" vs {single['plan_p50_ms']:.3f} ms, commit p50 "
          f"{sh['commit_p50_ms']:.3f} ms vs {single['commit_p50_ms']:.3f} "
          f"ms (sharded vs unsharded); demotions {sh['demotions']}, "
          f"rebuilds {sh['rebuilds']}; warm rows per rank "
          f"{[r['local_warm_rows'] for r in ranks]}; launches "
          f"{[r['launches'] for r in ranks]} for {sh['plans']} plans")
    drop = ("value_ids",)
    return {"ranks": [{k: v for k, v in r.items() if k not in drop}
                      for r in ranks],
            "unsharded": {k: v for k, v in single.items() if k not in drop},
            "spawn_s": spawn_s, "hit_by_both": len(both)}


# ---------------------------------------------------------------------------
# phase 14: the launch layer's dry-run
# ---------------------------------------------------------------------------

def _dryrun_file(prefix: str, arch: str, shape: str, flags) -> str:
    mp = "mp" if "--multi-pod" in flags else "sp"
    tag = flags[flags.index("--tag") + 1] if "--tag" in flags else ""
    return f"{prefix}_{arch}_{shape}_{mp}_train" + (f"_{tag}" if tag else "")\
        + ".json"


def dryrun_phase(card: str) -> dict:
    """14(a): ``python -m repro_torch.launch.dryrun`` for every pair of
    ``DRYRUN_PAIRS``, each in a process of its own (its fake group of 256
    or 512 ranks never meets a real one), all started together, and
    `localcost.local_count_check` beside them; each must finish within
    ``DRYRUN_TIMEOUT_S`` with exit code 0, and every op that ran outside
    ``DTensor``'s sharding strategies must be a known gap
    (`dryrun.KNOWN_FALLBACKS`).  Beside them, `dryrun.loop_count_check`
    for each mixer of ``LOOP_MIXERS`` at ``LOOP_CHECK_TOKENS``: on this
    host's torch, its counted token loops must count exactly as its real
    ones."""
    import tempfile

    import torch

    from repro_torch.launch.dryrun import LOOP_MIXERS, check_fallbacks
    tmp = tempfile.mkdtemp(prefix="dryrun-")
    prefix = os.path.join(tmp, "dr")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    cmds = [[sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", sh, "--device", "cuda", "--out", prefix, *flags]
            for a, sh, flags in DRYRUN_PAIRS]
    cmds.append([sys.executable, "-c",
                 "import json; from repro_torch.launch.localcost import "
                 "local_count_check as f; print(json.dumps(f()))"])
    n_loop = len(LOOP_MIXERS)
    for m in LOOP_MIXERS:
        cases = [(m, sh, LOOP_CHECK_TOKENS)
                 for sh in ("train_4k", "prefill_32k")]
        cmds.append([sys.executable, "-c",
                     "import json; from repro_torch.launch.dryrun import "
                     f"loop_count_check as f; print(json.dumps(f({cases!r})))"])
    t0 = time.perf_counter()
    procs = []
    for i, cmd in enumerate(cmds):
        out = open(os.path.join(tmp, f"out{i}.txt"), "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=out,
                                       stderr=subprocess.STDOUT, cwd=ROOT),
                      out))
    try:
        for (p, out), cmd in zip(procs, cmds):
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                p.wait(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                fail(f"dry-run {cmd[3:7]} did not finish within "
                     f"{DRYRUN_TIMEOUT_S} s")
            out.close()
            if p.returncode != 0:
                with open(out.name) as f:
                    tail = f.read()[-4000:]
                fail(f"dry-run {cmd[3:]} exited {p.returncode}:\n{tail}")
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    wall = time.perf_counter() - t0

    def last_json(i):
        with open(procs[i][1].name) as f:
            return json.loads(f.read().strip().splitlines()[-1])
    counts = last_json(-1 - n_loop)
    for case, (got, hand) in counts.items():
        if got != hand:
            fail(f"local flop count of the {case} product is {got}, by hand "
                 f"{hand}")
    print(f"  local flop counts equal the hand counts: "
          f"{ {c: v[0][0] for c, v in counts.items()} }")
    loops = {}
    for i in range(n_loop):
        loops.update(last_json(len(procs) - n_loop + i))
    for case, r in loops.items():
        counted, real = dict(r["counted"]), dict(r["real"])
        if not (counted.pop("counted_loops") >= 1
                and real.pop("counted_loops") == 0):
            fail(f"loop check {case}: the counted run counted no loop, or "
                 f"the real run counted one")
        diff = {k: (counted[k], real[k]) for k in counted
                if counted[k] != real[k]}
        if diff:
            fail(f"loop check {case}: the counted loops differ from the "
                 f"real ones: {diff}")
    print(f"  counted token loops equal the real loops on torch "
          f"{torch.__version__} (args, output, temp, flops, bytes, "
          f"collectives, fallbacks): "
          + "; ".join(f"{c}: flops {r['real']['flops']:.6e}, temp "
                      f"{r['real']['temp']}" for c, r in loops.items()))
    rows = {}
    print(f"  {'pair':<52} {'args':>7} {'temp':>9} {'flops/dev':>10} "
          f"{'bytes/dev':>10} {'coll B/dev':>10} {'t_comp':>9} "
          f"{'t_mem':>10} {'t_coll':>10}  bound   (GiB, ms; {card})")
    for a, sh, flags in DRYRUN_PAIRS:
        with open(_dryrun_file(prefix, a, sh, flags)) as f:
            r = json.load(f)
        mem, rf = r["memory"], r["roofline"]
        key = " ".join((a, sh, "x".join(map(str, r["mesh"])),
                        *[x for x in flags
                          if x.startswith(("--c", "--a", "--e"))],
                        *(["again"] if "again" in flags else [])))
        rows[key] = {
            "mesh": r["mesh"], "mesh_axes": r["mesh_axes"],
            "constrain_acts": r["constrain_acts"],
            "args_bytes": mem["argument_bytes_per_device"],
            "output_bytes": mem["output_bytes_per_device"],
            "temp_bytes": mem["temp_bytes_per_device"],
            "peak_gib": mem["peak_estimate_gib"],
            "device_memory_bytes": mem["device_memory_bytes"],
            "flops": rf["per_device_flops"], "bytes": rf["per_device_bytes"],
            "collective_bytes": rf["per_device_collective_bytes"],
            "collective_counts": rf["collective_counts"],
            "collective_by_link": rf["collective_by_link"],
            **{k: rf[k] for k in ("t_compute", "t_memory", "t_collective",
                                  "t_bound", "bottleneck")},
            "model_flops": r["model_flops"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "fallbacks": r["fallbacks"],
            "axes_sharding_args": r["mesh_axes_sharding_args"],
            "run_s": r["compile_seconds"], "build_place_s": r["lower_seconds"],
            "counted_loops": r["counted_loops"],
            "extrapolated": bool(r.get("extrapolated")),
        }
        x = rows[key]
        print(f"  {key:<52} {x['args_bytes'] / 2**30:7.3f} "
              f"{x['temp_bytes'] / 2**30:9.2f} {x['flops']:10.3e} "
              f"{x['bytes']:10.3e} {x['collective_bytes']:10.3e} "
              f"{x['t_compute'] * 1e3:9.3f} {x['t_memory'] * 1e3:10.3f} "
              f"{x['t_collective'] * 1e3:10.3f}  {x['bottleneck']}")
        print(f"  {'':<52} fallbacks {x['fallbacks'] or 'none'}; counted "
              f"token loops {x['counted_loops']}; run {x['run_s']} s")
        try:
            check_fallbacks(key, x["fallbacks"])
        except RuntimeError as e:
            fail(str(e))
        if not (x["flops"] > 0 and x["bytes"] > 0 and x["args_bytes"] > 0):
            fail(f"dry-run {key} counted no work")
        if math.prod(r["mesh"]) > 1 and not x["collective_bytes"] > 0:
            fail(f"dry-run {key} issued no collective")
        if a in DRYRUN_LOOP_ARCHS and sh != "decode_32k" and \
                not x["counted_loops"] > 0:
            fail(f"dry-run {key} counted no token loop")
        if "--multi-pod" in flags and "pod" not in x["axes_sharding_args"]:
            fail(f"multi-pod dry-run {key}: no argument sharded over pod "
                 f"({x['axes_sharding_args']})")
    first = rows["langcache-shardmap cache_lookup 16x16"]
    again = rows["langcache-shardmap cache_lookup 16x16 again"]
    same = ("args_bytes", "output_bytes", "temp_bytes", "flops", "bytes",
            "collective_bytes", "collective_counts", "fallbacks")
    diff = {k: (first[k], again[k]) for k in same if first[k] != again[k]}
    if diff:
        fail(f"the shardmap cache dry-run counted differently in a second "
             f"process: {diff}")
    print(f"  the 16x16 shardmap cache dry-run repeats exactly in a second "
          f"process ({', '.join(same)})")
    # --attn-bf16: decode's attention stays float32 (the reference's
    # apply_decode), so its counts do not move; prefill's plain attention
    # keeps P and the PV sums in bf16
    dec = rows["phi3-mini-3.8b decode_32k 16x16"]
    dec_b = rows["phi3-mini-3.8b decode_32k 16x16 --attn-bf16"]
    diff = {k: (dec[k], dec_b[k]) for k in same if dec[k] != dec_b[k]}
    if diff:
        fail(f"decode_32k counts moved under --attn-bf16: {diff}")
    pre = rows["phi3-mini-3.8b prefill_32k 16x16"]
    pre_b = rows["phi3-mini-3.8b prefill_32k 16x16 --attn-bf16"]
    print(f"  --attn-bf16: decode_32k counts equal ({', '.join(same)}); "
          f"prefill_32k bytes/dev {pre['bytes']:.6e} -> {pre_b['bytes']:.6e}"
          f", temp {pre['temp_bytes'] / 2**30:.3f} -> "
          f"{pre_b['temp_bytes'] / 2**30:.3f} GiB (without -> with; {card})")
    if not pre_b["bytes"] < pre["bytes"]:
        fail(f"prefill_32k under --attn-bf16 moves {pre_b['bytes']:.6e} "
             f"bytes, not fewer than {pre['bytes']:.6e}")
    print(f"  {len(DRYRUN_PAIRS)} dry-runs in {wall:.1f} s (in parallel)")
    return {"pairs": rows, "local_counts": counts, "loop_check": loops,
            "wall_s": wall}


def cache_program_phase(dev, one: dict, card: str) -> dict:
    """14(b): the dry-run's cache program at one rank, for real on the
    card: the full-width encoder on CACHE_SHAPE's 1024 queries of 64
    tokens, then `core.store.query` over 1,048,576 float32 keys through
    the float32-key cosine top-k kernel; then the same program over the
    same keys in bf16 (``build_cache_program(keys_dtype=bfloat16)``:
    float32 queries with bf16 keys, the bf16-key kernel).  Each run's
    arguments must hold the program's argument bytes (the float32 run the
    dry-run's, the bf16 run the port's bf16 program's, N D 2 fewer); its
    time (median of CUDA-event runs) is set beside the dry-run's
    ``t_bound`` and its peak memory (above what the process held before
    the phase) beside the dry-run's peak estimate.  Each kernel is held to
    its plain version at this shape first, and must launch once a run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import store
    from repro_torch.kernels.cosine_topk import kernel, ops, ref
    from repro_torch.launch.programs import (
        CACHE_CAPACITY, CACHE_SHAPE, build_cache_program)
    from repro_torch.launch.sharding import tree_leaves
    from repro_torch.models import Encoder

    cfg = get_config("modernbert-149m").replace(
        scan_layers=False, unroll_inner=True, remat=False)
    Q, T, N, D = CACHE_SHAPE.global_batch, CACHE_SHAPE.seq_len, \
        CACHE_CAPACITY, cfg.d_model
    free_cuda()
    base = torch.cuda.memory_allocated(dev)   # earlier phases' leftovers
    enc = Encoder(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    keys = torch.randn((N, D), generator=gen, device=dev)
    keys /= torch.linalg.vector_norm(keys, dim=-1, keepdim=True)
    i32 = torch.int32
    st = store.StoreState(
        keys=keys, valid=torch.ones(N, dtype=torch.bool, device=dev),
        last_used=torch.zeros(N, dtype=i32, device=dev),
        inserted_at=torch.zeros(N, dtype=i32, device=dev),
        value_ids=torch.arange(N, dtype=i32, device=dev),
        clock=torch.zeros((), dtype=i32, device=dev))
    tokens = torch.randint(0, cfg.vocab_size, (Q, T), generator=gen,
                           device=dev, dtype=i32)
    lengths = torch.randint(8, T + 1, (Q, 1), generator=gen, device=dev)
    mask = torch.arange(T, device=dev)[None] < lengths

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    def one_store(st, want_bytes, count, what):
        arg_bytes = nbytes(list(enc.parameters()) + list(st)
                           + [tokens, mask])
        if arg_bytes != want_bytes:
            fail(f"the cache program ({what}) holds {arg_bytes} argument "
                 f"bytes; the program counts {want_bytes}")

        def run():
            with torch.no_grad():
                emb = enc.encode(tokens, mask)
                return store.query(st, emb, threshold=0.9, k=1)

        with torch.no_grad():
            qn = store._normalise(enc.encode(tokens, mask)).contiguous()
            ks, ki = ops.cosine_topk(qn, st.keys, st.valid, 1)
            ps, pi = ref.cosine_topk(qn, st.keys, st.valid, 1)
        torch.cuda.synchronize()
        err = float((ks - ps).abs().max())
        if not torch.equal(ki, pi) or err > SCORE_ATOL:
            fail(f"cosine_topk ({what}) at Q={Q} N={N}: indices equal "
                 f"{torch.equal(ki, pi)}, max score error {err:.3e}")
        del ks, ki, ps, pi
        free_cuda()
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for key in kernel.COUNTS:
            kernel.COUNTS[key] = 0
        times = []
        for _ in range(CACHE_RUN_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            res = run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        launches = dict(kernel.COUNTS)
        peak = torch.cuda.max_memory_allocated(dev) - base
        if launches != {k: CACHE_RUN_REPS if k == count else 0
                        for k in kernel.COUNTS}:
            fail(f"cache program ({what}): launches {launches} in "
                 f"{CACHE_RUN_REPS} runs, expected {count} once a run")
        if not (res.slots.shape == (Q, 1) and bool(torch.isfinite(
                res.scores).all())):
            fail(f"the cache program's result ({what}) is not (Q, 1) "
                 "finite scores")
        with torch.no_grad():              # the two stages apart
            emb = enc.encode(tokens, mask)
            encode_ms = cuda_ms(lambda: enc.encode(tokens, mask), iters=1,
                                reps=CACHE_RUN_REPS)
            query_ms = cuda_ms(lambda: store.query(st, emb, 0.9, k=1),
                               iters=1, reps=CACHE_RUN_REPS)
        ms = statistics.median(times)
        return {"ms": ms, "times_ms": times, "launches": launches[count],
                "encode_ms": encode_ms, "query_ms": query_ms,
                "max_abs_err": err, "arg_bytes": arg_bytes,
                "peak_bytes": peak, "qn": qn}

    want = one["args_bytes"]
    out = one_store(st, want, "cosine_topk", "float32 keys")
    out.pop("qn")
    t_bound_ms = one["t_bound"] * 1e3
    dry_peak = one["args_bytes"] + one["temp_bytes"]
    ms, peak, err = out["ms"], out["peak_bytes"], out["max_abs_err"]
    out.update({"t_bound_ms": t_bound_ms,
                "bound_fraction": t_bound_ms / ms,
                "dryrun_bottleneck": one["bottleneck"],
                "dryrun_terms_ms": {k: one[k] * 1e3 for k in (
                    "t_compute", "t_memory", "t_collective")},
                "dryrun_arg_bytes": want, "dryrun_peak_bytes": dry_peak,
                "peak_factor": dry_peak / peak,
                "at": f"Q={Q} T={T} N={N} D={D}", "card": card})
    print(f"  cache program at one rank: {ms:.2f} ms (median of "
          f"{CACHE_RUN_REPS}; {card}); dry-run t_bound {t_bound_ms:.2f} ms "
          f"({out['dryrun_bottleneck']}): t_bound / measured "
          f"{out['bound_fraction']:.3f}")
    print(f"  arguments {out['arg_bytes']:,} bytes = the dry-run's; peak "
          f"memory {peak / 2**30:.2f} GiB against the dry-run's estimate "
          f"{dry_peak / 2**30:.2f} GiB (x{out['peak_factor']:.2f}); "
          f"cosine_topk launches {out['launches']}, max |score - plain| "
          f"{err:.2e}")
    print(f"  apart: encode {out['encode_ms']:.2f} ms, store.query "
          f"(cosine_topk kernel) {out['query_ms']:.2f} ms")

    # the same program over bf16 keys: float32 q x bf16 keys
    st = st._replace(keys=keys.bfloat16())
    del keys
    free_cuda()
    prog = build_cache_program(variant="auto", keys_dtype=torch.bfloat16)
    want_b = nbytes(tree_leaves(prog.args))
    del prog
    if want_b != want - N * D * 2:
        fail(f"the bf16 cache program counts {want_b} argument bytes, not "
             f"the float32 one's {want} less N D 2")
    ob = one_store(st, want_b, "cosine_topk_bf16", "bf16 keys")
    qn = ob.pop("qn")
    kb, valid = st.keys, st.valid

    def kern():
        return ops.cosine_topk(qn, kb, valid, 1)

    def plain():
        return ref.cosine_topk(qn, kb, valid, 1)

    def library():
        return torch.topk(torch.where(valid, qn @ kb.float().T, -1e30), 1)
    with torch.no_grad():
        bound, by = topk_bound_ms(Q, N, D, 1, 4, 2)
        ob.update(kernel_ms=cuda_ms(kern, iters=1, reps=CACHE_RUN_REPS),
                  plain_ms=cuda_ms(plain, iters=1, reps=3),
                  library_ms=cuda_ms(library, iters=1, reps=3),
                  bound_ms=bound, bound_by=by)
    free_cuda()
    ob.update({"peak_factor": dry_peak / ob["peak_bytes"],
               "at": f"float32 q x bf16 keys, Q={Q} T={T} N={N} D={D}",
               "card": card})
    print(f"  bf16 keys (float32 q x bf16 keys, the bf16-key kernel): "
          f"{ob['ms']:.2f} ms (float32 keys {ms:.2f}); arguments "
          f"{ob['arg_bytes']:,} bytes = the port's bf16 program's "
          f"(float32 less N D 2); peak {ob['peak_bytes'] / 2**30:.2f} GiB; "
          f"launches {ob['launches']}, max |score - plain| "
          f"{ob['max_abs_err']:.2e}")
    print(f"  apart: encode {ob['encode_ms']:.2f} ms, store.query "
          f"{ob['query_ms']:.2f} ms (float32 keys {out['query_ms']:.2f}); "
          f"the kernel alone {ob['kernel_ms']:.3f} ms, plain "
          f"{ob['plain_ms']:.2f}, library (widened matmul + topk) "
          f"{ob['library_ms']:.2f}, bound {bound:.3f} ({by})")
    out["bf16_keys"] = ob
    del enc, st, tokens, mask, qn, kb, valid
    free_cuda()
    return out


def sass_counts(lib: str) -> dict:
    """{kernel function (mangled): {"HMMA": n, "FFMA": n, "HMMA_TF32": n,
    "HMMA_BF16": n}} in a built library, from ``cuobjdump --dump-sass``
    (beside ``nvcc``); the last two count the tensor-core products by
    input type (``HMMA.1688.F32.TF32``, ``HMMA.16816.F32.BF16``)."""
    from repro_torch.kernels import _build
    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([exe, "--dump-sass", lib], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump on {lib}: {res.stderr.strip()}")
    out, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = {"HMMA": 0, "FFMA": 0, "HMMA_TF32": 0,
                         "HMMA_BF16": 0}
        elif name is not None:
            for op in ("HMMA", "FFMA"):
                out[name][op] += f" {op}" in line
            if " HMMA" in line:
                out[name]["HMMA_TF32"] += ".TF32" in line
                out[name]["HMMA_BF16"] += ".BF16" in line
    return out


def resource_usage(lib: str) -> dict:
    """{kernel function (mangled): {"REG": n, "STACK": n, "LOCAL": n}}
    from ``cuobjdump --dump-resource-usage``: a spill shows as stack or
    local memory."""
    from repro_torch.kernels import _build
    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([exe, "--dump-resource-usage", lib],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump on {lib}: {res.stderr.strip()}")
    out, name = {}, None
    for line in res.stdout.splitlines():
        if "Function " in line:
            name = line.split("Function ", 1)[1].strip().rstrip(":")
        elif name is not None and "REG:" in line:
            out[name] = {f: int(line.split(f + ":", 1)[1].split()[0])
                         for f in ("REG", "STACK", "LOCAL")
                         if f + ":" in line}
            name = None
    return out


def sass_phase(libs: dict) -> dict:
    """Every flash kernel runs on the tensor cores: the bf16 ones on bf16
    products, the float32 ones on TF32 products (3xTF32), the float32
    bf16-accumulate one on both (q k^T in TF32, P V in bf16); cosine
    top-k over float32 keys on the FMA units and over bf16 keys on bf16
    products: counted in the built SASS.  The bf16 decode kernels of the
    mma path run on the tensor cores and the cascade kernels on the FMA
    units, and neither they, the contrastive, cosine top-k nor flash
    kernels spill."""
    fa = sass_counts(libs["flash_attention"])
    bf16 = {n: c for n, c in fa.items()
            if "flash_attention_bf16_kernel" in n
            or "flash_attention_bf16_acc_bf16_kernel" in n}
    f32 = {n: c for n, c in fa.items()
           if "flash_attention_f32_kernel" in n}
    f32_acc = {n: c for n, c in fa.items()
               if "flash_attention_f32_acc_bf16_kernel" in n}
    if not bf16 or any(c["HMMA_BF16"] == 0 or c["HMMA_TF32"]
                       for c in bf16.values()):
        fail(f"flash_attention: a bf16 kernel without bf16 HMMA, or with "
             f"TF32: {bf16}")
    if not f32 or any(c["HMMA_TF32"] == 0 or c["HMMA_BF16"]
                      for c in f32.values()):
        fail(f"flash_attention: a float32 kernel without TF32 HMMA, or "
             f"with bf16: {f32}")
    if not f32_acc or any(c["HMMA_TF32"] == 0 or c["HMMA_BF16"] == 0
                          for c in f32_acc.values()):
        fail(f"flash_attention: a float32 bf16-accumulate kernel without "
             f"both TF32 and bf16 HMMA: {f32_acc}")
    ct = sass_counts(libs["cosine_topk"])
    part = {n: c for n, c in ct.items() if "cosine_topk_partial_kernel" in n}
    ct_mma = {n: c for n, c in ct.items() if "cosine_topk_mma_kernel" in n}
    if any(c["HMMA"] for n, c in ct.items() if n not in ct_mma) or not part \
            or any(c["FFMA"] == 0 for c in part.values()):
        fail(f"cosine_topk: HMMA outside the bf16-key kernels or FFMA "
             f"missing in a float32-key kernel: {ct}")
    if not ct_mma or any(c["HMMA_BF16"] == 0 or c["HMMA_TF32"]
                         for c in ct_mma.values()):
        fail(f"cosine_topk: a bf16-key kernel without bf16 HMMA, or with "
             f"TF32: {ct_mma}")
    da = sass_counts(libs["decode_attention"])
    mma = {n: c for n, c in da.items() if "decode_mma_kernel" in n}
    if not mma or any(c["HMMA"] == 0 for c in mma.values()):
        fail(f"decode_attention: an mma kernel without HMMA: {da}")
    if any(c["HMMA"] for n, c in da.items() if n not in mma):
        fail(f"decode_attention: HMMA outside the mma kernels: {da}")
    cl = sass_counts(libs["cascade_lookup"])
    if any(c["HMMA"] for c in cl.values()) or not any(
            c["FFMA"] for n, c in cl.items() if "cascade_score_kernel" in n):
        fail(f"cascade_lookup: HMMA present or FFMA missing: {cl}")
    usage = {}
    for name in ("decode_attention", "cascade_lookup", "contrastive",
                 "cosine_topk"):
        usage[name] = resource_usage(libs[name])
        spills = {n: u for n, u in usage[name].items()
                  if u.get("STACK", 0) or u.get("LOCAL", 0)}
        if not usage[name] or spills:
            fail(f"{name}: spills (stack or local memory) or no resource "
                 f"usage read: {spills or usage[name]}")
    usage["flash_attention"] = resource_usage(libs["flash_attention"])
    acc = {n: u for n, u in usage["flash_attention"].items()
           if "acc_bf16" in n}
    spills = {n: u for n, u in usage["flash_attention"].items()
              if u.get("STACK", 0) or u.get("LOCAL", 0)}
    if len(usage["flash_attention"]) != len(fa) or spills:
        fail(f"flash_attention: kernels spill (stack or local memory) or "
             f"were not read: {spills or usage['flash_attention']}")
    out = {
        "decode_attention": {
            "kernels": len(da), "mma_kernels": len(mma),
            "mma_HMMA": sum(c["HMMA"] for c in mma.values()),
            "max_registers": max(u["REG"] for u in
                                 usage["decode_attention"].values()),
            "spills": 0},
        "cascade_lookup": {
            "kernels": len(cl), "FFMA": sum(c["FFMA"] for c in cl.values()),
            "HMMA": 0,
            "max_registers": max(u["REG"] for u in
                                 usage["cascade_lookup"].values()),
            "spills": 0},
        "flash_attention": {
            "acc_bf16_kernels": sum("acc_bf16" in n for n in fa),
            "acc_bf16_max_registers": max(u["REG"] for u in acc.values()),
            "max_registers": max(u["REG"] for u in
                                 usage["flash_attention"].values()),
            "spills": 0,
            "bf16_kernels": len(bf16),
            "bf16_HMMA": sum(c["HMMA"] for c in bf16.values()),
            "f32_kernels": len(f32),
            "f32_HMMA_TF32": sum(c["HMMA_TF32"] for c in f32.values()),
            "f32_acc_bf16_kernels": len(f32_acc),
            "f32_acc_bf16_HMMA_TF32": sum(c["HMMA_TF32"]
                                          for c in f32_acc.values()),
            "f32_acc_bf16_HMMA_BF16": sum(c["HMMA_BF16"]
                                          for c in f32_acc.values())},
        "cosine_topk": {
            "kernels": len(ct), "mma_kernels": len(ct_mma),
            "FFMA": sum(c["FFMA"] for c in part.values()),
            "HMMA_BF16": sum(c["HMMA_BF16"] for c in ct_mma.values()),
            "HMMA_outside_mma": 0,
            "mma_max_registers": max(
                u["REG"] for n, u in usage["cosine_topk"].items()
                if "cosine_topk_mma_kernel" in n),
            "max_registers": max(u["REG"] for u in
                                 usage["cosine_topk"].values()),
            "spills": 0},
        "contrastive": {
            "kernels": len(usage["contrastive"]),
            "max_registers": max(u["REG"] for u in
                                 usage["contrastive"].values()),
            "spills": 0}}
    print(f"  SASS: flash_attention {out['flash_attention']}; "
          f"cosine_topk {out['cosine_topk']}; decode_attention "
          f"{out['decode_attention']}; cascade_lookup "
          f"{out['cascade_lookup']}; contrastive {out['contrastive']}")
    for name in ("decode_attention", "cascade_lookup", "contrastive",
                 "cosine_topk", "flash_attention"):
        print(f"  registers per thread, {name}: " + "; ".join(
            f"{n[:60]} {u['REG']}" for n, u in usage[name].items()))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.cascade_lookup import kernel as cascade_kernel
    from repro_torch.kernels.contrastive import kernel as cl_kernel
    from repro_torch.kernels.cosine_topk import kernel as topk_kernel
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products of the plain versions: float32 sums, one rounding
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    print("phase 1: build")
    t0 = time.perf_counter()
    builds = {"cascade_lookup": cascade_kernel.build,
              "cosine_topk": topk_kernel.build,
              "contrastive": cl_kernel.build,
              "flash_attention": fa_kernel.build,
              "decode_attention": da_kernel.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        futs = {n: pool.submit(b) for n, b in builds.items()}
        libs = {n: str(f.result()) for n, f in futs.items()}
    for n, lib in libs.items():
        print(f"  {n}: {os.path.relpath(lib, ROOT)}")
    print(f"  built in {time.perf_counter() - t0:.1f} s")
    sass = sass_phase(libs)

    print("phase 2: kernel parity (cascade and ensemble cascade at serving "
          "shapes, cosine top-k at flat-cache shapes, contrastive at "
          "training shapes, flash and decode attention at decoder "
          "shapes)")
    kp = kernel_phase(dev)
    ep = ensemble_kernel_phase(dev)
    tp = topk_phase(dev)
    cp = contrastive_phase(dev)
    check_contrastive_one_launch(cp)
    ap = attention_kernel_phase(dev)
    if "--kernels-only" in sys.argv[1:]:
        print(card)
        print(json.dumps({"phase2": {"cascade_lookup": kp,
                                     "cascade_lookup_ensemble": ep,
                                     "cosine_topk": tp, "contrastive": cp,
                                     "attention": ap}}, default=str))
        return 0

    print("phase 3: serving (full-width encoder, fused cascade)")
    sv = serving_phase(dev)

    print("phase 4: fine-tuning (full-width encoder, the paper's recipe)")
    tr = training_phase(dev)

    print("phase 5: flat serving (fine-tuned encoder, SemanticCache)")
    fl = flat_serving_phase(dev, tr["trainer"], tr["tok"])

    print(f"phase 6: ensemble serving ({ENS_E} full-width panels, learned "
          "mixture weights)")
    embed_fn, names = ensemble_embed_fn(dev, tr["trainer"], tr["tok"])
    from repro_torch.data import make_query_stream
    sc = ensemble_score_report(embed_fn, names, make_query_stream(
        "medical", N_REQUESTS, seed=11, repeat_frac=0.4))
    ens_thr = min(sc["max_unrelated"] + ENS_MARGIN, 1.0)
    if not sc["max_unrelated"] < ens_thr:
        fail(f"no ensemble threshold above the largest different-meaning "
             f"fused score {sc['max_unrelated']:.6f}")
    print(f"  threshold {ens_thr:.6f}; pairs of different meaning at or "
          f"above it: fused {int((sc['fused'][~sc['para']] >= ens_thr).sum())}"
          f", pilot alone {int((sc['pilot'][~sc['para']] >= ens_thr).sum())}"
          " (why miss coalescing stays off)")
    print("  (a) serving through CachedLLMService")
    es = ensemble_serving_phase(dev, embed_fn, ens_thr, tr["tok"])
    print("  (b) learning the mixture weights (canonical answers, 2 "
          "tenants)")
    el = ensemble_learning_phase(dev, embed_fn, names, ens_thr)

    print(f"phase 7: decoder serving (full-width {DECODER})")
    dcfg = decoder_config()
    print("  (a) generation through ServeEngine")
    gn = generation_phase(dev, dcfg)
    print("  (c) CachedLLMService: tuned encoder, tiered cache, decoder")
    ls = llm_serving_phase(dev, gn["engine"], tr["trainer"], tr["tok"])
    print("  (d) attn_f32=False: bf16 attention weights and sums")
    t7d = time.perf_counter()
    ab = acc_bf16_phase(dev, dcfg, gn)
    print(f"  7(d) in {time.perf_counter() - t7d:.1f} s")

    # phase 8 runs while the phase-7 decoder is alive (8(d) drives it);
    # 7(b) builds its float32 copy after that one is freed
    print("phase 8: the maintenance loop (cold tier, background rebuild, "
          "conformal calibration, continuous batcher)")
    t8 = time.perf_counter()
    embs = embed_batches(sv["embed_fn"], sv["texts"])
    print("  (a) cold tier behind an int8 warm ring (phase 3's trace)")
    ct = cold_tier_phase(dev, embs, sv["texts"])
    print("  (b) double-buffered IVF rebuild (phase 3's configuration)")
    bg = background_rebuild_phase(dev, embs, sv["texts"])
    print("  (c) conformal hit calibration (phase 6(b) with the floor)")
    elc = ensemble_learning_phase(dev, embed_fn, names, ens_thr,
                                  conformal=True, embs=el["embs"])
    budget = 0.01
    for t, c in elc["tenants"].items():
        o = el["tenants"][t]
        print(f"  tenant {t}: threshold {o['threshold']:.6f} -> "
              f"{c['threshold']:.6f}, floor {c['floor']}; hit rate "
              f"{o['hit_rate']:.4f} -> {c['hit_rate']:.4f}; false hits per "
              f"hit {o['false_hit_share']:.4f} -> {c['false_hit_share']:.4f}"
              f" (budget {budget}; without -> with conformal)")
    if not any(elc["floor_above"].values()):
        fail("conformal: no tenant's floor rose above its learned "
             "threshold")
    print("  (d) continuous batcher over the decoder, (b)'s maintenance on "
          "idle ticks")
    cb = batcher_phase(dev, gn["lm"], bg["cache"].maintenance)
    print(f"  phase 8 in {time.perf_counter() - t8:.1f} s")
    del gn["lm"], gn["engine"], bg["cache"]
    free_cuda()
    print("  (b) float32 decode against forward_lm (teacher-forced)")
    df = decode_forward_phase(dev, dcfg)
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          " GB")
    free_cuda()

    print("phase 9: the online embedder refresh (untuned full-width "
          "encoder, phase 3's trace)")
    t9 = time.perf_counter()
    rp = refresh_phase(dev)
    print(f"  phase 9 in {time.perf_counter() - t9:.1f} s")
    free_cuda()

    print(f"phase 10: the MoE decoder (full-width {MOE_DECODER})")
    t10 = time.perf_counter()
    mcfg = moe_decoder_config()
    print("  (a) generation through ServeEngine")
    mg = moe_generation_phase(dev, mcfg)
    print("  (b) kernels against the plain attention versions")
    mp = moe_plain_phase(dev, mg, mcfg)
    print("  (c) CachedLLMService: tuned encoder, tiered cache, MoE decoder")
    ml = llm_serving_phase(dev, mg["engine"], tr["trainer"], tr["tok"])
    if (ml["hits"], ml["misses"]) != (ls["hits"], ls["misses"]):
        fail(f"moe llm serving: hits / misses {ml['hits']} / "
             f"{ml['misses']}, phase 7(c) {ls['hits']} / {ls['misses']}")
    print(f"  phase 10 in {time.perf_counter() - t10:.1f} s")
    del mg["lm"], mg["engine"]
    free_cuda()

    print("phase 11: the rest of the decoder zoo (xLSTM-125M, Jamba cut to "
          f"{JAMBA_POSITIONS} layers, MusicGen-large, Pixtral-12B)")
    t11 = time.perf_counter()
    zoo = zoo_phase(dev, tr["trainer"], tr["tok"], ls)
    print(f"  phase 11 in {time.perf_counter() - t11:.1f} s")

    print(f"phase 12: decoder training (full-width {DECODER} at "
          f"B={TRAIN_B} S={TRAIN_S}, {MOE_DECODER}, xlstm-125m)")
    t12 = time.perf_counter()
    dt = decoder_training_phase(dev)
    ot = other_training_phase(dev)
    print(f"  phase 12 in {time.perf_counter() - t12:.1f} s")
    free_cuda()

    print(f"phase 13: the sharded warm tier ({SHARDS} stacked shards; "
          f"{MESH_RANKS} ranks on one card)")
    t13 = time.perf_counter()
    print(f"  (a) the stacked form, one process, S={SHARDS}")
    sa = sharded_stacked_phase(dev)
    sm = sharded_mesh_phase(dev, embs, sv["texts"])
    print(f"  phase 13 in {time.perf_counter() - t13:.1f} s")
    free_cuda()

    print("phase 14: the launch layer's dry-run (fake process groups, the "
          "H100 roofline)")
    t14 = time.perf_counter()
    print(f"  (a) {len(DRYRUN_PAIRS)} dry-runs, each in its own process")
    dr = dryrun_phase(card)
    print("  (b) the cache program at one rank on the card")
    cpr = cache_program_phase(dev, dr["pairs"]["langcache cache_lookup 1x1"],
                              card)
    print(f"  phase 14 in {time.perf_counter() - t14:.1f} s")
    print(f"  all phases in {time.perf_counter() - t_start:.1f} s")

    n_flat = FLAT_CAPACITY
    b_train = CONTRASTIVE_B[0]
    cpb = cpr["bf16_keys"]
    kernels = [{
        "name": "cascade_lookup", "route": "cuda",
        "source": "src/repro_torch/kernels/cascade_lookup/csrc/"
                  "cascade_lookup.cu",
        "replaces": "src/repro/kernels/cascade_lookup/kernel.py:626",
        "launches": sv["launches"], "max_abs_err": kp["max_abs_err"],
        "ms": kp["ms"], "plain_ms": kp["plain_ms"],
        "bound_ms": kp["bound_ms"], "bound_by": kp["bound_by"],
        "library_ms": None,
        "graph_ms": kp["graph_ms"], "device_kernels": kp["device_kernels"],
        "int8_ms": kp["int8_ms"], "int8_graph_ms": kp["int8_graph_ms"],
        "int8_plain_ms": kp["int8_plain_ms"],
        "int8_bound_ms": kp["int8_bound_ms"],
        "serving_p50_ms": sv["p50_ms"], "serving_hit_rate": sv["hit_rate"],
        "zoo_llm_launches": zoo["xlstm-125m"]["llm"]["cascade_launches"],
        "zoo_llm_plans": zoo["xlstm-125m"]["llm"]["plans"],
        "refresh_launches": rp["cascade_launches"],
        "refresh_plans": rp["plans"],
        "background_rebuild_launches": bg["launches"],
        "background_rebuild_plans": bg["plans"],
        "cold_tier_int8_launches": ct["launches"],
        "cold_tier_plans": ct["plans"],
        "cold_tier_stage_p50_mean_ms": ct["stage_ms"],
        "cold_tier": ct["cold"],
        "sharded": {
            "stacked": {k: v for k, v in sa.items()
                        if not k.startswith(("fp32_ens", "int8_ens"))},
            "mesh_ranks": [{k: v for k, v in r.items()
                            if not k.startswith("ensemble")}
                           for r in sm["ranks"]],
            "mesh_service_launches": [r["launches"] for r in sm["ranks"]],
            "unsharded_service": sm["unsharded"]},
        "sass": sass["cascade_lookup"], "card": card,
    }, {
        "name": "cosine_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/cosine_topk/csrc/cosine_topk.cu",
        "replaces": "src/repro/kernels/cosine_topk/kernel.py:86",
        "launches": fl["launches"], "max_abs_err": tp["max_abs_err"],
        **tp["by_n"][n_flat],
        "at": f"Q=64 D=768 N={n_flat} k=1",
        "by_n": tp["by_n"],
        "bf16q_f32keys_by_n": tp["bf16q_f32keys_by_n"],
        "flat_p50_ms": fl["p50_ms"],
        "flat_hit_rate": fl["hit_rate"], "sass": sass["cosine_topk"],
        "cache_program_launches": cpr["launches"],
        "cache_program": {k: v for k, v in cpr.items()
                          if k not in ("card", "bf16_keys")},
        "card": card,
    }, {
        "name": "cosine_topk_bf16", "route": "cuda",
        "source": "src/repro_torch/kernels/cosine_topk/csrc/cosine_topk.cu",
        "replaces": "src/repro/kernels/cosine_topk/kernel.py:86",
        "launches": cpb["launches"],
        "max_abs_err": max(tp["bf16_keys_max_abs_err"], cpb["max_abs_err"]),
        "ms": cpb["kernel_ms"], "plain_ms": cpb["plain_ms"],
        "bound_ms": cpb["bound_ms"], "bound_by": cpb["bound_by"],
        "library_ms": cpb["library_ms"],
        "library": "torch.topk of the float32 matmul of the widened keys",
        "at": cpb["at"] + " k=1 (14(b))",
        "mixed_by_n": tp["mixed_by_n"], "bf16_by_n": tp["bf16_by_n"],
        "cache_program": {k: v for k, v in cpb.items() if k != "card"},
        "sass": sass["cosine_topk"], "card": card,
    }, {
        "name": "contrastive_components", "route": "cuda",
        "source": "src/repro_torch/kernels/contrastive/csrc/contrastive.cu",
        "replaces": "src/repro/kernels/contrastive/kernel.py:95",
        "launches": tr["launches"]["contrastive_components"],
        "max_abs_err": cp["max_abs_err"],
        "ms": cp["by_b"][b_train]["fwd_ms"],
        "graph_ms": cp["by_b"][b_train]["fwd_graph_ms"],
        "device_kernels": cp["by_b"][b_train]["fwd_device_kernels"],
        "plain_ms": cp["by_b"][b_train]["plain_fwd_ms"],
        "bound_ms": cp["by_b"][b_train]["fwd_bound_ms"],
        "bound_by": cp["by_b"][b_train]["fwd_bound_by"],
        "library_ms": None, "at": f"B={b_train} D=768",
        "by_b": {b: {k: v for k, v in d.items() if k.startswith("fwd")
                     or k == "plain_fwd_ms"}
                 for b, d in cp["by_b"].items()},
        "launch_floor_ms": cp["launch_floor_ms"],
        "launch_floor_graph_ms": cp["launch_floor_graph_ms"],
        "train_step_p50_ms": tr["step_p50_ms"], "sass": sass["contrastive"],
        "refresh_launches": rp["launches"]["contrastive_components"],
        "refresh_steps": rp["steps"], "card": card,
    }, {
        "name": "contrastive_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/contrastive/csrc/contrastive.cu",
        "replaces": None,
        "launches": tr["launches"]["contrastive_backward"],
        "max_abs_err": cp["max_abs_err"],
        "ms": cp["by_b"][b_train]["bwd_ms"],
        "graph_ms": cp["by_b"][b_train]["bwd_graph_ms"],
        "device_kernels": cp["by_b"][b_train]["bwd_device_kernels"],
        "plain_ms": cp["by_b"][b_train]["plain_bwd_ms"],
        "bound_ms": cp["by_b"][b_train]["bwd_bound_ms"],
        "bound_by": cp["by_b"][b_train]["bwd_bound_by"],
        "library_ms": None, "at": f"B={b_train} D=768",
        "bwd_bound_all_rows_ms":
            cp["by_b"][b_train]["bwd_bound_all_rows_ms"],
        "by_b": {b: {k: v for k, v in d.items() if k.startswith("bwd")
                     or k in ("plain_bwd_ms", "hard_pairs")}
                 for b, d in cp["by_b"].items()},
        "launch_floor_graph_ms": cp["launch_floor_graph_ms"],
        "refresh_launches": rp["launches"]["contrastive_backward"],
        "refresh_steps": rp["steps"], "card": card,
    }, {
        "name": "cascade_lookup_ensemble", "route": "cuda",
        "source": "src/repro_torch/kernels/cascade_lookup/csrc/"
                  "cascade_lookup.cu",
        "replaces": "src/repro/kernels/cascade_lookup/kernel.py:501",
        "launches": es["launches"], "max_abs_err": ep["max_abs_err"],
        "ms": ep["ms"], "plain_ms": ep["plain_ms"],
        "bound_ms": ep["bound_ms"], "bound_by": ep["bound_by"],
        "library_ms": None, "at": f"E={ENS_E} Q=64 D=768 k=1",
        "graph_ms": ep["graph_ms"], "device_kernels": ep["device_kernels"],
        "int8_ms": ep["int8_ms"], "int8_graph_ms": ep["int8_graph_ms"],
        "int8_plain_ms": ep["int8_plain_ms"],
        "int8_bound_ms": ep["int8_bound_ms"],
        "learning_launches": el["launches"],
        "conformal_launches": elc["launches"],
        "serving_p50_ms": es["p50_ms"], "serving_hit_rate": es["hit_rate"],
        "sharded_stacked_launches_per_plan": {
            t: sa[f"{t}_launches_per_plan"]["cascade_lookup_ensemble"]
            for t in ("fp32", "int8")},
        "sharded_stacked_ms": {t: sa[f"{t}_ensemble_ms"]
                               for t in ("fp32", "int8")},
        "sharded_mesh_ms": [{k: v for k, v in r.items()
                             if k.startswith("ensemble")}
                            for r in sm["ranks"]],
        "sass": sass["cascade_lookup"], "card": card,
    }]
    for name, key, main_shape, moe_shape, src, replaces, step in (
            ("flash_attention", "flash", "phi3 prefill bfloat16",
             "granite prefill bfloat16",
             "flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:115", "prefill"),
            ("decode_attention", "decode", "phi3 decode bfloat16",
             "granite decode bfloat16",
             "decode_attention/csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention/kernel.py:74", "decode")):
        row = ap[key]["by_shape"][main_shape]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}", "replaces": replaces,
            "launches": ls["launches"][name],
            "max_abs_err": ap[key]["max_abs_err"],
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms", "graph_ms",
                                   "library_graph_ms")},
            "library": "F.scaled_dot_product_attention (KV heads expanded)",
            "at": main_shape, "by_shape": ap[key]["by_shape"],
            "generate_launches": gn["launches"][name],
            "decode_vs_forward_max_abs_err": df["max_abs_err"],
            "prefill_ms": gn["prefill_ms"], "decode_ms": gn["decode_ms"],
            "tokens_per_s": gn["tokens_per_s"],
            "llm_generate_p50_ms": ls["p50_ms"].get("generate"),
            "llm_hit_rate": ls["hit_rate"], "sass": sass.get(name),
            "batcher_launches": cb["launches"][name],
            "batcher": {k: v for k, v in cb.items() if k != "launches"},
            **({"acc_bf16": {
                "at": main_shape, "library_ms": None,
                "library": "none: no PyTorch call rounds the weights and "
                           "the accumulator as attn_f32=False does (SDPA "
                           "computes the attn_f32=True function)",
                "launches": ab["launches"][name],
                "max_abs_err": ap["flash_acc_bf16"]["max_abs_err"],
                **{k: ap["flash_acc_bf16"]["by_shape"][main_shape][k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                             "graph_ms", "plain_graph_ms", "mean_abs_err",
                             "plain_gap_mean")},
                "by_shape": ap["flash_acc_bf16"]["by_shape"],
                **{k: ab[k] for k in ("prefill_ms", "decode_ms",
                                      "tokens_per_s", "token_agreement",
                                      "teacher_forced", "long_prefill",
                                      "fp32")}}}
               if name == "flash_attention" else
               {"acc_bf16_launches": ab["launches"][name]}),
            "moe_at": moe_shape,
            "moe_generate_launches": mg["launches"][name],
            "moe_llm_launches": ml["launches"][name],
            "moe_vs_plain_max_abs_err": mp["max_abs_err"],
            "moe_vs_plain_mean_abs_err": mp["mean_abs_err"],
            "moe_fp32_vs_plain_max_abs_err": mp["fp32_max_abs_err"],
            "moe_prefill_ms": mg["prefill_ms"],
            "moe_decode_ms": mg["decode_ms"],
            "moe_tokens_per_s": mg["tokens_per_s"],
            "train_bf16_nll_abs_err": dt["bf16_nll"]["abs_err"],
            "train_fp32_nll_rel_err": dt["fp32_nll"]["rel_err"],
            "train_bf16_attention_max_abs_err":
                dt["bf16_nll"]["attention_max_abs_err"],
            "train_fp32_attention_max_abs_err":
                dt["fp32_nll"]["attention_max_abs_err"],
            "zoo": {z: {"at": (f"{z.split('-')[0]} {step} bfloat16"
                               if z != "xlstm-125m" else None),
                        "generate_launches": zoo[z]["launches"][name],
                        "llm_launches": zoo[z].get("llm", {}).get(
                            "launches", {}).get(name),
                        "fp32_decode_vs_forward_max_abs_err":
                            zoo[z]["decode_vs_forward"]["max_abs_err"],
                        **{k: zoo[z][k] for k in (
                            "prefill_ms", "decode_ms", "tokens_per_s",
                            "peak_gb", "step_launches")}}
                    for z in ZOO},
            "card": card,
        })
    print(json.dumps({"training": {
        DECODER: {k: dt[k] for k in ("params", "step_ms", "tokens_per_s",
                                     "peak_gb", "fixed_losses", "profile",
                                     "top_kernels_ms", "optimizer_ms",
                                     "attention", "bf16_nll", "fp32_nll")},
        **{n: {k: r[k] for k in ("params", "step_ms", "tokens_per_s",
                                  "peak_gb")} for n, r in ot.items()},
        "at": f"B={TRAIN_B} S={TRAIN_S}", "card": card}}))
    print(json.dumps({"dryrun": {"pairs": dr["pairs"],
                                 "local_counts": dr["local_counts"],
                                 "wall_s": dr["wall_s"],
                                 "cache_program": cpr, "card": card}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
