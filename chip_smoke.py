#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Drives the port's eleven paths once on one NVIDIA card, the first six at
the paper's configuration (``ClimberConfig()``: n=256, w=16, r=200, m=10,
c=3000, K=500), with every kernel's launch count zeroed just before each
path and read just after it:

1. **serve**: generates a z-normalised random-walk dataset on the card from
   ``--seed``, builds the CLIMBER index on the card, and serves queries
   drawn from the dataset through ``ClimberEngine`` (adaptive at batch 64,
   k=500; ``knn`` and ``od_smallest`` one batch each), then one adaptive
   tick of 4,096 other queries, the benchmark's tick: the batches of 64
   take ``refine_topk``'s query-major design and the tick its
   partition-major one, and each design's launch count must be non-zero.
   After the counts are read, ``refine_topk`` on that tick's plan is held
   against its plain version.
2. **evaluation** (Fig. 7): for the main dataset and for ``sift``, ``dna``,
   ``eeg`` and ``seismic`` at ``--other-num`` series each, the exact ground
   truth of 64 queries by Dss (``GroundTruthCache`` → ``exact_knn`` → the
   ``pairwise_l2`` kernel), then CLIMBER (``adaptive``, ``knn``,
   ``recall_target`` at spend 2), DPiSAX and TARDIS (cardinality 8,
   capacity c), each scored by tie-aware recall@K and MAP; DPiSAX also
   answers through the dense refine (the ``qdots`` kernel), held against
   its fused answer.  Every method runs over the whole dataset.  Last, a
   seismic tenant corpus (4 shards, affinity 0.6) with perturbed queries,
   2K true neighbours and the hard/easy split.
3. **fleet**: a seismic tenant corpus of 4 × ``--fleet-shard`` series
   (affinity 0.6), one ``IndexFleet.add_shard`` per tenant; 256 perturbed
   queries through ``FleetEngine`` (batch 64, k=500, signature routing,
   fan-out 2, adaptive) with ``placement="host"`` and ``"mesh"`` (the
   stacked one-card pass), which must agree bit for bit, scored against
   ``scan_exact``; one exhaustive fan-out batch against ``scan_exact`` and
   ``scan_exact`` against Dss; the online recall sentinel on the same 256
   queries (``sentinel_rate=0.05``, recalibration every 4 audits, two
   audits after each tick, then ``drain()``: answers bit-equal with it on
   and off, the audits exactly the queries its seeded RNG draws, their mean
   recall equal to ``recall_at_k`` against Dss through the plain
   ``pairwise_l2``); ingest under load (64 insert batches of
   1,024 rows into a WAL-durable fleet under ``build/``, each followed by a
   serving tick that runs maintenance, so the delta seals twice in the
   background; acknowledged rows must read back at once), a 4-batch WAL
   tail, ``save()`` and ``IndexFleet.open()`` (answers bit-equal), and a
   ``maintenance`` merge of the two sealed delta shards (exhaustive answers
   unchanged).  After its launch counts are read, ``refine_topk`` is held
   against its plain version at two of the fleet's shapes: one shard's
   stacked-pass plan and ``scan_exact``'s exhaustive refine over the union
   store.
4. **net**, on that fleet: ``serve_in_thread(FleetEngine(fleet, batch
   size 64, k=500, signature routing, fan-out 2))`` on 127.0.0.1 (its
   admission sized for 256 requests in flight), 256 queries through one
   pipelined ``ClimberClient.query_batch``, then 4 concurrent clients × 64
   single queries that retry on ``RetryLater``, each client a process of
   its own; the metrics page, the
   flight recorder's traces and the health card over the same socket.
   Every socket answer must equal ``IndexFleet.query`` bit for bit and the
   server must drain and stop.  After its launch counts are read,
   ``refine_topk`` is held against its plain version on a two-row tick's
   plans over every sealed shard and over the live delta.
5. **mesh**, on that fleet and the serve path's index: one card as the
   slots of ``make_mesh(D, devices=[card] * D)``.  ``ClimberEngine`` with
   ``mesh=`` 4 slots over the 2^22-series index (256 adaptive queries at
   batch 64) must equal the one-device engine bit for bit; the fleet
   (5 sealed shards and a live delta) on 3 slots (padded to 6) and on 4
   (padded to 8), signature routing at fan-out 2 and exhaustive routing,
   cold and cached, must equal ``placement="host"`` bit for bit,
   ``partitions_touched`` and ``candidates_scanned`` included, with the
   batch ms beside the one-slot stacked pass; ``scan_exact(mesh=)`` on 4
   slots must equal ``scan_exact()``; ``exact_knn_sharded`` of 64 queries
   over the 2^22 series on 4 slots must equal ``exact_knn`` (ids up to
   k-th ties, d² within 1e-5·(‖q‖²+‖x‖²)); and one ``maxmin`` build of
   ``--fleet-shard`` series beside a random one must store every record
   exactly once.  The one-device answers are computed before the launch
   counts are zeroed.  After they are read, ``refine_topk`` is held
   against its plain version on the engine's slot 1 of 4 and the fleet's
   slot 1 of 4.
6. **frontier**: ``run_frontier`` at ``ClimberConfig()`` (a spec subclass
   whose ``shard_cfg()`` returns it) over ``randomwalk`` and ``seismic``
   tenant corpora at 1 and 4 shards of ``--frontier-shard`` series, 64
   queries, 32 calibration queries, the spec's fan-outs, thresholds, spend
   factors (1, 2, 4) and slot budgets (4, 16), ground truth by Dss
   through a ``GroundTruthCache``.  Hard checks: exhaustive routing scans at
   least as much as every routed cell; a slot budget b touches at most
   b × shards partitions; on seismic × 4, a fresh evaluation fleet scans
   as the sweep did, and its exhaustive routing with the exhaustive planner
   and the sweep's cached ground truth both give the answer of Dss through
   the plain ``pairwise_l2`` up to k-th-distance ties.  After its launch
   counts are read, ``pairwise_l2`` is held against its plain version on
   one Dss chunk of the sweep (64 queries × 2,048 series), and
   ``refine_topk`` on shard 0's exhaustive and spend-4 plans.

7. **lm**, the LM serving plane, after every earlier path's data is
   freed: (a) internlm2-1.8b (``LM_ARCH``) at its full config, bf16
   parameters from a seeded generator, a lone request through ``Engine``
   equal token for token to a ``prefill`` + ``decode_step`` loop, then
   ``Engine(slots=8, max_len=512)`` draining 32 requests (prompt lengths
   drawn in 32-256 among those the chunked prefill accepts, 32 new tokens
   each), and ``decode_step`` against ``forward`` at the last of 256
   positions of 8 rows (the greedy token equal where the top-1/top-2 gap
   exceeds 0.3, max |Δ| reported); (b) the kNN-LM of
   ``examples/knn_lm.py`` at that width: a datastore of 32 steps
   (half the example's 2^20 rows: the index's dense store pads every
   partition to the fullest, 92.8 GB at 2^20 rows of these skewed states) ×
   16 × 1,023 hidden-state proxies (``logits[..., :d_model]``, next token
   as label) from ``TokenPipeline``, a CLIMBER index over it on the card
   (n=2048, w=16, r=48, m=6, c=256, K=16, adaptive 4X), 64 next-token
   queries of 256-token contexts through ``knn_query`` and the example's
   interpolation (λ = 0.25, T = 1): each mixture sums to 1 within 1e-3,
   the answer equals the plain refine of its plan (gids exact), and
   recall@16 is measured against Dss over the whole datastore, and, after
   the path's counts are read, split by cause: recall@16 at spend 4 and
   with the exhaustive plan over the same index, and where the true
   neighbours rank among all rows by PAA-16 distance; (c), run
   before (b), every other architecture at full width, one at a time
   (mistral-large-123b cut to 4 of 88 layers, llama-3.2-vision-90b to 10
   of 100: one card's 80 GB), each an ``Engine`` drain of 2 requests of
   256 tokens and 8 new tokens, and decode against forward as in (a) (on
   one 8-token prompt for the capacity-dropping MoE archs; one SSD chunk
   for the SSM archs; without RoPE for encdec, whose decode ropes its
   cross-attention query at position 0 as the reference does).  Each
   architecture, and (a)'s, also holds decode against forward in fp32 at
   full width, every logit within 1e-3·(1+|logit|): at full depth where
   its fp32 weights fit in 24 GB, else at its shallowest (2 layers, or one
   hybrid / vlm group).
   After its counts are read, ``paa``, ``pivot_rank`` (m = 6),
   ``refine_topk`` (n = 2048, K = 16) and ``pairwise_l2`` are held against
   their plain versions and timed at the path's shapes.
8. **tp**, the model axis, after the lm path's weights are freed (it runs
   none of the CLIMBER kernels: its launch counts are zeros).  Every mesh
   is slots of this one card (``make_mesh(shape, ("data", "model"),
   [card] * n)``), so no number of it says what several cards gain.
   (a) internlm2-1.8b at full width, bf16, on ``TP_MESH`` = (1, 4) (its
   8 kv heads split): ``forward`` of 8 × 256 tokens against one device by
   the lm rules (the greedy token equal where the top-1/top-2 gap exceeds
   0.3), then ``prefill`` of the 8 rows and 16 ``decode_step`` ticks, the
   mesh fed the one-device run's greedy tokens, each tick's logits by the
   same rule, with tick ms, tokens/s and one profiled tick's kernel
   launches and device ms beside the one-device run's; (b) fp32 at full
   width on ``TP_DECODE_MESH`` = (1, 16), the production model width (kv =
   8 does not divide: the cache splits by sequence), a 255-token prefill
   into a 272-slot cache and 2 ticks under ``set_decode_shard`` against
   one device, every logit within 1e-3·(1+|logit|); (c) olmoe-1b-7b at
   full width in fp32, 4 of its 16 layers, 4 × 64 tokens on (2, 2) against
   each data half run alone on one device (the MoE capacity counts one
   data shard's tokens), within 1e-3·(1+|logit|); (d) the train step at
   full width on (2, 4): first one fp32 step of 2 × 1,024 tokens against
   the one-device step, AdamW's first moment — after one step (1 - b1)·clip
   times each leaf's reduced grad — within 1e-4 of each leaf's largest
   entry (a piece's grad zeroed, swapped or summed into the wrong slot
   fails it); then bf16, sequence 1,024, batch 8, 3 steps (AdamW, lr 3e-4)
   against the one-device step, which runs first and is kept on the host:
   every loss and ``embed/out`` within 5e-2 (the reference's bound), step
   s, tokens/s and peak memory beside the one-device step's; (e) its bf16
   params (3.8 GB) saved from
   (2, 4) with ``save_checkpoint(layout=)`` under ``build/`` and restored
   onto (2, 2) byte-equal, the directory removed; (f)
   ``make_production_mesh(devices=[card] * 256)`` lays the trained params
   out and gathers them back byte-equal; (g) each family split after dense
   GQA and MoE — minicpm3-4b (MLA), mamba2-780m (SSM, 12 of 48 layers),
   zamba2-2.7b (hybrid, one group of 6 of 54 layers), whisper-large-v3
   (encdec), llama-3.2-vision-90b (vlm, 10 of 100 layers; the SSM cuts
   are for conditioning, ``TP_BF16_LAYERS``) — at full width in bf16 on
   (1, 4): ``forward`` of 8 × 256
   tokens, ``prefill`` and 16 ticks against one device by the lm rules,
   with tick ms, kernel launches and device ms per tick beside the
   one-device run's (whose weights are freed before the mesh's pieces
   run); (h) minicpm3-4b (its latent cache split by sequence, the heads
   by ``kv_up``) and mamba2-780m (SSD weights that do not follow their
   heads) in fp32 on (1, 4): forward, a 256-token prefill into a
   272-slot cache and 2 ticks at full depth, every logit within
   1e-3·(1+|logit|); (i) mamba2-780m's fp32 step of 2 × 1,024 tokens at
   6 of its 48 layers on (2, 4) against one device, AdamW's first moment
   within 1e-4 of each leaf's largest entry.
9. **train**, the training plane, after the tp path's weights are freed
   (it runs none of the CLIMBER kernels: its launch counts are zeros):
   (a) ``train()`` of internlm2-1.8b (``TRAIN_ARCH``) at its full width,
   seeded random bf16 weights, ``remat="dots"``, train_4k's sequence of
   4,096 tokens, a global batch of 8 sequences in 4 microbatches of 2, 12
   steps of the periodic token data of ``examples/train_lm.py`` (AdamW,
   warmup-cosine to lr 3e-4), a checkpoint at step 8 and the final one
   at 12 under ``build/`` (removed after; ``TRAIN_EVERY`` says why not
   every 4); the token draws raise ``StepFailure`` once, at step 9, before
   it computes, so the run restores from step 8's checkpoint and finishes
   at 12.  Hard checks: every loss and grad norm finite, the mean
   of the last 3 losses below that of the first 3, the restored parameters
   and moments byte-equal to the tensors saved, step 8's loss after the
   restore bit-equal to its first, the checkpoint's keys, shapes and
   dtypes those of the reference's stacked tree with bf16 leaves stored as
   ``'<V2'``.  One more step is timed in parts (data, forward + backward,
   optimizer).  (b) At 4 of the 24 layers, on one batch: the microbatched
   step's loss within 5e-2 of the unsplit step's, and
   ``shard_train_step`` on ``make_mesh(2, [card] * 2)`` against the
   one-slot step (a (data, model) mesh with one model slot: the state
   laid out by ``make_state_shardings``, each microbatch's rows split over
   the slots): loss within 1e-5 relative, weights within 5e-2.  (c) One
   step each of mamba2-780m (the SSD scan's backward) and olmoe-1b-7b
   (``moe_local``'s) at full width and 2 layers: finite loss and grads,
   the loss equal to ``cross_entropy(Model.forward(...))`` of the same
   parameters (within ``MOE_LOSS_RTOL`` for the MoE).  ``--lm-smoke``
   shrinks the path to the smoke configs, 64 tokens and 6 steps.
10. **dryrun**, the dry-run tools (``repro_torch.launch.dryrun`` /
    ``climber_dryrun``): (a) ``run_cell`` of internlm2-1.8b × ``train_4k``
    and × ``decode_32k`` and the CLIMBER build and query steps (128M × 256,
    50 queries), each counted on ``make_production_mesh(devices=["meta"] *
    256)`` with nothing allocated: one line per cell with its compute,
    memory and collective seconds against the H100's rates, bottleneck,
    roofline fraction and the host seconds of the count; (b) internlm2-1.8b
    decode of 8 rows over a 4,096-token cache on one device, counted on
    ``meta`` and then run on the card: the counted argument bytes must
    equal the allocator's requested bytes, and its growth of
    ``memory_allocated()`` must lie between them rounded to 512 B a tensor
    and that plus 1 MiB a tensor of 1 MiB or more (a block whose tail is
    that small is not split); the tick ms against the counted bound;
    (c) one slot's share of (16, 16) on the card: 128M / 256 = 500,000
    random walks through the build step (``paa``, ``pivot_rank``,
    assignment, trie routing on the synthetic skeleton) and ``refine_topk``
    of 50 queries × 16 whole partitions of the slot's 166 partitions of
    3,000 × 256, each timed with CUDA events against the counted per-slot
    bound; after its counts are read, ``paa``, ``pivot_rank`` and
    ``refine_topk`` are held against their plain versions at these shapes.
11. **perf**, the reference's perf switches at internlm2-1.8b's full
    width: the train step of the train path's shape (seq 4,096, batch 8 in
    4 microbatches, remat) with ``set_flash_bf16`` off and on, two steps
    each from the same weights: step s, the plain attention's part of it
    and peak GB, losses within 5e-2 (the reference's rule); then 8 ticks of
    decode at 8 slots over a 512-token cache with
    ``set_cache_update_masked`` off and on: logits bit-equal, ms a tick.

Then, off the paths, it holds each CUDA kernel against its plain PyTorch
version on the same inputs at the paths' shapes, times both with CUDA
events (and the one PyTorch call that computes the same function, where
there is one; ``paa`` and ``pivot_rank`` also at one tick's 64 query
rows, with the profiler's device time; ``paa`` also bit for bit against
``paa_sequential``, its order of additions, on up to 8,192 sampled rows at
every shape it is timed at; ``refine_topk`` on three plans — adaptive on
queries 0-63, adaptive on the traced tick's queries 64-127, and
``od_smallest`` — each with the (query, record) pairs it keeps, the
distinct records behind them and its byte bound), reads each redesigned
kernel's registers and spills from the ``ptxas`` build log, traces one more adaptive tick with
``torch.profiler`` (device busy time and idle share), checks the engine
against per-query ``knn_query``, and requires the exhaustive plan to
reproduce the Dss answer up to k-th-distance ties.  Any failed check raises and the script exits
non-zero.  Output, in order: phase lines, one ``{"kernels": [...]}`` JSON
line, the card's ``nvidia-smi`` name and power limit, and the last line
``{"ok": true, "device": {...}}``.  ``--report PATH`` also writes a longer
JSON report there.

Usage: ``python3 chip_smoke.py [--seed 0] [--num 4194304] [--queries 256]
[--other-num 1048576] [--tenant-shard 262144] [--fleet-shard 1048576]
[--frontier-shard 1048576] [--lm-smoke] [--report PATH]``
from the repository root (it puts ``src/`` on ``sys.path`` itself).  It
needs a CUDA card and ``nvcc``; without a card it exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s and
# non-tensor fp32 FLOP/s.  The roofline bound of a kernel is the larger of
# its bytes over the first and its FLOPs over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def work_bound(work):
    """``bound_ms`` of a kernel's work function's ``(flops, nbytes)``: the
    work the dry-run counts on ``meta`` for the same call."""
    return bound_ms(work.nbytes, work.flops)


def say(*parts) -> None:
    print(*parts, flush=True)


def ptxas_table(log: str):
    """``{kernel entry: {"registers", "spill_stores", "spill_loads"}}`` from
    nvcc's ``-Xptxas -v`` output, entry names demangled where a demangler
    is on the machine."""
    table, entry = {}, None
    for ln in log.splitlines():
        if "Compiling entry function '" in ln:
            entry = ln.split("'")[1]
            table[entry] = {}
        elif entry and "bytes spill stores" in ln:
            f = [int(t) for t in ln.replace(",", " ").split() if t.isdigit()]
            table[entry].update(spill_stores=f[1], spill_loads=f[2])
        elif entry and "Used" in ln and "registers" in ln:
            table[entry]["registers"] = int(ln.split("Used")[1].split()[0])
    for tool in ("cu++filt", "/usr/local/cuda/bin/cu++filt", "c++filt"):
        if shutil.which(tool) and table:
            out = subprocess.run([tool], input="\n".join(table), text=True,
                                 capture_output=True).stdout.splitlines()
            if len(out) == len(table):
                names = (o.replace("void ", "").replace("(int)", "").replace(
                    "(bool)", "").split("::", 1)[-1].split("(")[0] for o in out)
                return dict(zip(names, table.values()))
    return table


SERVE_KERNELS = ("paa", "pivot_rank", "refine_topk")
TICK_QUERIES = 4096      # the benchmark cells' tick
EVAL_KERNELS = ("paa", "pivot_rank", "refine_topk", "pairwise_l2", "qdots")
EVAL_QUERIES = 64
SCAN_CHUNK = 1 << 20          # Dss rows per pairwise_l2 launch


def sync_wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, card synchronised."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def assert_same_topk(label, d2_a, g_a, d2_b, g_b, tol):
    """The refine_topk rule: ``|Δd²| ≤ tol`` per query, and answer sets that
    differ only at the k-th distance (a near-tie under another summation
    order).  Returns (max |Δd²|, queries whose gids differ)."""
    import torch
    derr = (d2_a - d2_b).abs()
    if bool((derr > tol).any()):
        raise SystemExit(f"{label}: |Δd²| {float(derr.max())} exceeds "
                         f"1e-5·(‖q‖²+‖x‖²)")
    kth = d2_b[:, -1:]
    differ = (g_a != g_b).any(1)
    for i in differ.nonzero()[:, 0].tolist():
        extra = torch.tensor(sorted(set(g_a[i].tolist()) - set(g_b[i].tolist())),
                             device=g_a.device, dtype=g_a.dtype)
        if extra.numel():
            d_extra = d2_a[i][torch.isin(g_a[i], extra)]
            if bool(((d_extra - kth[i]).abs() > tol[i]).any()):
                raise SystemExit(f"{label}: query {i} answer set differs "
                                 f"away from the k-th distance")
    return float(derr.max()), int(differ.sum())


def l2_check(label, q, x):
    """``pairwise_l2`` against its plain version on ``q`` × ``x``:
    ``|Δd²| ≤ 1e-5·(‖q‖²+‖x‖²)`` per entry.  Returns max |Δd²|."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.l2 import pairwise_l2_plain
    assert not torch.backends.cuda.matmul.allow_tf32
    d_k = ops.pairwise_l2(q, x)
    d_p = pairwise_l2_plain(q, x)
    tol = 1e-5 * ((q * q).sum(-1, keepdim=True) + (x * x).sum(-1)[None, :])
    err = (d_k - d_p).abs()
    if bool((err > tol).any()):
        raise SystemExit(f"{label}: |Δd²| {float(err.max())} exceeds "
                         f"1e-5·(‖q‖²+‖x‖²)")
    return float(err.max())


def cuda_ms(fn, iters=5, warmup=2):
    """Mean CUDA-event milliseconds of ``fn()`` over ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, kernel, iters=20):
    """Mean device time of the kernels named ``*kernel*`` per call of
    ``fn``, from a profiler trace: at a small shape the event timing is the
    host's launch cost, not the kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pr:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in pr.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name)
    return us / 1e3 / iters if us else None


def pivot_rank_check(z, piv, m):
    """``pivot_rank`` against its plain version: rows may differ only at
    near-ties, within a distance gap of 1e-5·(‖x‖²+‖p‖²).  Returns (rows
    differing, gap)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.pivot_rank import pivot_rank_plain
    s_k = ops.pivot_rank(z, piv, m)
    s_p = pivot_rank_plain(z, piv, m)
    bad = (s_k != s_p).any(dim=1).nonzero()[:, 0]
    gap = 0.0
    if bad.numel():
        zb = z[bad].double()
        d64 = ((zb[:, None, :] - piv.double()[None]) ** 2).sum(-1)   # exact
        dk = torch.gather(d64, 1, s_k[bad].long())
        dp = torch.gather(d64, 1, s_p[bad].long())
        gap = float((dk - dp).abs().max())
        tol = 1e-5 * float((zb * zb).sum(-1).max() + (piv * piv).sum(-1).max())
        if gap > tol:
            raise SystemExit(f"pivot_rank: {bad.numel()} rows differ with a "
                             f"distance gap {gap} > {tol}")
    say(f"pivot_rank: {bad.numel()} of {z.shape[0]} rows differ from the plain "
        f"version (m={m}), all within a distance gap of {gap:.3g}")
    return int(bad.numel()), gap


# One kernel row at any path's shapes: the check against the plain version,
# CUDA-event times of kernel, plain version and library call, and the bound.

def paa_row(x, w, iters=5, warmup=2, tick=False):
    """``paa`` on ``x`` against its plain version (max abs err ≤ 1e-5) and,
    bit for bit, against ``paa_sequential`` (its order of additions) on the
    CPU over up to 8,192 rows spread across ``x``; the library call is
    ``x.view(B, w, n // w).mean(-1)``.  At a ``tick``'s shape the event time
    is the host's launch cost, so the row adds the profiler's device time."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.paa_kernel import paa_plain, paa_sequential, paa_work
    b, n = x.shape
    got = ops.paa(x, w)
    err = float((got - paa_plain(x, w)).abs().max())
    if not err <= 1e-5:
        raise SystemExit(f"paa [{b}, {n}]: kernel vs plain max abs err {err} > 1e-5")
    k = min(b, 8192)
    rows = torch.arange(k, device=x.device) * b // k
    differ = int((got[rows].cpu() != paa_sequential(x[rows].cpu(), w)).any(1).sum())
    if differ:
        raise SystemExit(f"paa [{b}, {n}]: {differ} of {rows.numel()} sampled rows "
                         f"differ from paa_sequential's bits")
    bms, bby = work_bound(paa_work(b, n, w))
    return {"max_abs_err": err, "bit_equal_rows": int(rows.numel()),
            "ms": cuda_ms(lambda: ops.paa(x, w), iters, warmup),
            "plain_ms": cuda_ms(lambda: paa_plain(x, w), iters, warmup), "bound_ms": bms,
            "bound_by": bby,
            "library_ms": cuda_ms(lambda: x.view(b, w, n // w).mean(-1), iters, warmup),
            "shape": f"[{b},{n}] -> [{b},{w}]",
            **({"device_ms": device_ms(lambda: ops.paa(x, w), "paa")} if tick else {})}


def pivot_rank_row(z, piv, m, iters=5, warmup=2, plain_iters=5, plain_warmup=2):
    """``pivot_rank`` on ``z`` against its plain version
    (:func:`pivot_rank_check`), with the profiler's device time; the library
    call, ``torch.topk`` of the plain distances, is timed only (its tie
    order is not ``lax.top_k``'s)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.pivot_rank import (pivot_distances_plain, pivot_rank_plain,
                                                pivot_rank_work)
    (b, w), r = z.shape, piv.shape[0]
    bad, gap = pivot_rank_check(z, piv, m)
    bms, bby = work_bound(pivot_rank_work(b, w, r, m))
    return {"rows_differing": bad, "max_abs_err": gap,
            "ms": cuda_ms(lambda: ops.pivot_rank(z, piv, m), iters, warmup),
            "device_ms": device_ms(lambda: ops.pivot_rank(z, piv, m), "pivot_rank"),
            "plain_ms": cuda_ms(lambda: pivot_rank_plain(z, piv, m), plain_iters,
                                plain_warmup),
            "bound_ms": bms, "bound_by": bby,
            "library_ms": cuda_ms(lambda: torch.topk(pivot_distances_plain(z, piv), m,
                                                     dim=-1, largest=False, sorted=True),
                                  plain_iters, plain_warmup),
            "library_call": "torch.topk(pivot_distances_plain(z, piv), m, largest=False), "
                            "TF32 off",
            "shape": f"[{b},{w}] x [{r},{w}] -> [{b},{m}]"}


def pairwise_l2_row(q, x, label):
    """``pairwise_l2`` on ``q`` × ``x`` against its plain version
    (:func:`l2_check`)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.l2 import pairwise_l2_plain, pairwise_l2_work
    (nq, n), c = q.shape, x.shape[0]
    err = l2_check(label, q, x)
    bms, bby = work_bound(pairwise_l2_work(nq, c, n))
    return {"max_abs_err": err, "ms": cuda_ms(lambda: ops.pairwise_l2(q, x)),
            "plain_ms": cuda_ms(lambda: pairwise_l2_plain(q, x)),
            "bound_ms": bms, "bound_by": bby,
            "library_ms": cuda_ms(lambda: ((q * q).sum(-1, keepdim=True) - 2 * (q @ x.T)
                                           + (x * x).sum(-1)[None, :]).clamp_min(0)),
            "library_call": "(q2 - 2*(q @ x.T) + x2).clamp_min(0), TF32 off",
            "shape": f"[{nq},{n}] x [{c},{n}] -> [{nq},{c}]"}


def refine_bound(work, nq, mp, n, k):
    """``refine_topk``'s bound on a partition-sorted plan of ``nq`` queries
    and ``mp`` entries, from :func:`refine_work`'s counts
    (``refine_topk_work``, which the dry-run counts too)."""
    from repro_torch.kernels.refine_topk import refine_topk_work
    return work_bound(refine_topk_work(work["kept_pairs"], work["unique_kept_records"],
                                       work["live_slots"], nq, mp, n, k))


def plain_exact_knn(queries, data, k, chunk=SCAN_CHUNK):
    """Dss through ``pairwise_l2``'s plain version, a running top-k over
    ``chunk``-row slices: ``(d² [Q, k], row ids)``.  The reference that
    checks kernel answers independently of every kernel."""
    import torch
    from repro_torch.kernels.l2 import pairwise_l2_plain
    from repro_torch.kernels.refine_topk import topk_flat
    best_d = best_i = None
    for a in range(0, data.shape[0], chunk):
        d2 = pairwise_l2_plain(queries, data[a:a + chunk])
        ids = torch.arange(a, a + d2.shape[1], dtype=torch.int32,
                           device=d2.device).expand_as(d2)
        if best_d is not None:
            d2, ids = torch.cat([best_d, d2], 1), torch.cat([best_i, ids], 1)
        best_d, best_i = topk_flat(d2, ids, k)
    return best_d, best_i


def evaluate_dataset(name, data, queries, index, gt_cache, meta, cfg, gen):
    """Fig. 7 on one dataset: Dss truth, then CLIMBER, DPiSAX, TARDIS.

    Returns (rows, truth): one row per method, and the Dss answer over the
    whole dataset ``(dist, idx)`` as numpy.
    """
    import numpy as np
    import torch
    from repro_torch.baselines import (build_dpisax, build_tardis, dpisax_knn,
                                       tardis_knn)
    from repro_torch.core.query import knn_query
    from repro_torch.eval import mean_average_precision, recall_at_k

    k, nq, num = cfg.k, queries.shape[0], data.shape[0]
    m = dict(meta, rows=num)
    (d_gt, i_gt), secs = sync_wall(lambda: gt_cache.exact(
        m, queries, data, k, chunk=SCAN_CHUNK))
    say(f"  dss[{name}]: exact {k}-NN of {nq} queries over {num} series "
        f"in {secs:.3f} s ({-(-num // SCAN_CHUNK)} pairwise_l2 launches)")
    rows_out = []
    q2 = (queries.double() ** 2).sum(-1, keepdim=True)

    def score(method, dist, gid, secs, **extra):
        dist, gid = dist.cpu().numpy(), gid.cpu().numpy()
        row = {"dataset": name, "method": method, "rows": num,
               "recall": recall_at_k(gid, i_gt, k, approx_dist=dist,
                                     exact_dist=d_gt),
               "map": mean_average_precision(gid, i_gt, k),
               "ms_per_query": secs / nq * 1e3, **extra}
        rows_out.append(row)
        say(f"fig7[{name}] {method}: " + json.dumps(
            {a: (round(b, 4) if isinstance(b, float) else b) for a, b in row.items()
             if a not in ("dataset", "method")}))

    for variant in ("adaptive", "knn", "recall_target"):
        knn_query(index, queries[:8], k, variant=variant)          # warm-up
        (d, g, qp), secs = sync_wall(lambda: knn_query(index, queries, k,
                                                       variant=variant))
        score(f"climber-{variant}", d, g, secs,
              mean_partitions_touched=float(qp.partitions_touched().float().mean()))

    w = cfg.paa_segments
    dp, build_s = sync_wall(lambda: build_dpisax(
        data, segments=w, cardinality=8, capacity=cfg.capacity, device=data.device))
    dpisax_knn(dp, queries[:8], k)                                   # warm-up
    (d, g), secs = sync_wall(lambda: dpisax_knn(dp, queries, k))
    # the same queries through the dense refine (the qdots kernel)
    (d_dense, g_dense), secs_dense = sync_wall(
        lambda: dpisax_knn(dp, queries, k, use_kernel=False))
    tol = 1e-5 * (q2 + float(dp.store.norms.max()))
    err, differ = assert_same_topk(f"dpisax[{name}] dense vs fused",
                                   d_dense.double() ** 2, g_dense,
                                   d.double() ** 2, g, tol)
    score("dpisax", d, g, secs, build_s=build_s,
          partitions=dp.num_partitions, cap=dp.store.capacity,
          store_gb=dp.store.data.numel() * 4 / 1e9,
          dense_ms_per_query=secs_dense / nq * 1e3,
          dense_vs_fused_max_abs_err=err, dense_vs_fused_gid_queries=differ)
    del dp, d_dense, g_dense
    td, build_s = sync_wall(lambda: build_tardis(
        data, segments=w, cardinality=8, capacity=cfg.capacity,
        sample_frac=cfg.sample_frac, generator=gen, device=data.device))
    tardis_knn(td, queries[:8], k)                                   # warm-up
    (d, g), secs = sync_wall(lambda: tardis_knn(td, queries, k))
    score("tardis", d, g, secs, build_s=build_s,
          partitions=td.forest.num_partitions, cap=td.store.capacity,
          store_gb=td.store.data.numel() * 4 / 1e9)
    del td
    torch.cuda.empty_cache()
    return rows_out, (d_gt, i_gt)


FLEET_KERNELS = ("paa", "pivot_rank", "refine_topk")
FLEET_TENANTS = 4
INSERT_BATCHES, INSERT_ROWS, TAIL_BATCHES = 64, 1024, 4


def plain_refine_chunked(store, qs, sp, lo, hi, k, budget=4e9):
    """``refine_topk``'s plain version over a partition-sorted plan, in
    query chunks and, where the plan names each partition once (an
    exhaustive plan), in chunks of partition columns, each gathering at
    most ``budget`` bytes of rows; the chunks' top-k lists are merged by
    (d², column), the order of one plain pass."""
    import torch
    from repro_torch.kernels.refine_topk import masked_distances, topk_flat
    live_w = int((sp >= 0).sum(1).max())
    sp, lo, hi = (t[:, t.shape[1] - live_w:] for t in (sp, lo, hi))  # pads first
    per = store.capacity * store.data.shape[-1] * 4
    cols = max(1, min(live_w, int(budget // per)))
    if cols < live_w and bool(((sp[:, 1:] == sp[:, :-1]) & (sp[:, 1:] >= 0)).any()):
        raise SystemExit("plain refine: a repeated partition cannot be split "
                         "across column chunks")
    qc = max(1, int(budget // (cols * per)))
    out_d, out_g = [], []
    for a in range(0, qs.shape[0], qc):
        parts = [topk_flat(*masked_distances(
            store.data, store.norms, store.rec_dfs, store.rec_gid, qs[a:a + qc],
            sp[a:a + qc, c:c + cols], lo[a:a + qc, c:c + cols],
            hi[a:a + qc, c:c + cols]), k) for c in range(0, live_w, cols)]
        d, g = topk_flat(torch.cat([x[0] for x in parts], 1),
                         torch.cat([x[1] for x in parts], 1), k)
        out_d.append(d)
        out_g.append(g)
    return torch.cat(out_d), torch.cat(out_g), live_w


def refine_plan_checks(path, qs, k, cases) -> dict:
    """``refine_topk`` against its plain version on each ``(label, store,
    (sel_part, sel_lo, sel_hi))`` of ``cases``, the plan sorted by
    partition as the kernel's wrapper sorts it (stable, pads first).  Run
    after the path's launch counts are read, so these launches are not
    counted.  Returns one row per case."""
    import torch
    from repro_torch.kernels.refine_topk import refine_topk
    out = {}
    for label, store, plan in cases:
        order = torch.argsort(plan[0], dim=-1, stable=True)
        sp, lo, hi = (torch.gather(t, 1, order).to(torch.int32).contiguous()
                      for t in plan)
        (d2_k, g_k), secs = sync_wall(lambda: refine_topk(
            store.data, store.norms, store.rec_dfs, store.rec_gid, qs, sp, lo, hi, k))
        d2_p, g_p, live_w = plain_refine_chunked(store, qs, sp, lo, hi, k)
        tol = 1e-5 * ((qs * qs).sum(-1, keepdim=True) + float(store.norms.max()))
        err, differ = assert_same_topk(f"refine_topk [{path} {label}]", d2_k, g_k,
                                       d2_p, g_p, tol)
        out[label] = {"Q": qs.shape[0], "P": store.num_partitions,
                      "cap": store.capacity, "mp": sp.shape[1], "live_width": live_w,
                      "max_abs_err": err, "gid_queries_differ": differ,
                      "kernel_s": secs}
        say(f"refine_topk [{path} {label}]: max |Δd²| {err:.3g}; {differ} of "
            f"{qs.shape[0]} queries differ in gid order at near-ties; "
            + json.dumps(out[label], default=float))
        del d2_p, g_p
    return out


def host_plan(index, qs, variant):
    """The host loop's plan of ``qs`` on one index: featurize, then the
    ``variant`` planner (``IndexFleet._query_sealed_host``)."""
    from repro_torch.core.query import plan
    qp = plan(index, index.featurize(qs)[0], variant=variant)
    return qp.sel_part, qp.sel_lo, qp.sel_hi


def fleet_refine_checks(fleet, qs, k) -> dict:
    """``refine_topk`` at two of the fleet path's shapes: shard 0's
    stacked-pass plan (the pass's padded plan width, over the shard's own
    store) and ``scan_exact``'s exhaustive refine over the union store."""
    from repro_torch.core.query import exhaustive_selection
    from repro_torch.kernels import ops
    pl = fleet._ensure_placement()
    qp = pl.plan_shard(0, ops.paa(qs, fleet.cfg.shard_cfg.paa_segments), "adaptive")
    union = fleet._union_store()
    return refine_plan_checks("fleet", qs, k, (
        ("stacked pass, shard " + fleet.shards[0].key, fleet.shards[0].index.store,
         (qp.sel_part, qp.sel_lo, qp.sel_hi)),
        ("scan_exact union", union,
         exhaustive_selection(union.num_partitions, qs.shape[0], qs.device))))


def net_refine_checks(fleet, qs, k) -> dict:
    """``refine_topk`` at the net path's shapes: a socket tick's few rows
    over every sealed shard's stacked-pass plan and over the live delta
    (its one-partition bootstrap store, or its own index's plan)."""
    import torch
    from repro_torch.kernels import ops
    pl = fleet._ensure_placement()
    z = ops.paa(qs, fleet.cfg.shard_cfg.paa_segments)
    cases = []
    for j, shard in enumerate(fleet.shards):
        qp = pl.plan_shard(j, z, "adaptive")
        cases.append((f"stacked pass, shard {shard.key}", shard.index.store,
                      (qp.sel_part, qp.sel_lo, qp.sel_hi)))
    delta = fleet.delta
    if delta.occupancy:
        if delta.index is None:
            sel = torch.zeros((qs.shape[0], 1), dtype=torch.int32, device=qs.device)
            cases.append(("delta", delta.store(), (sel, sel, sel + 1)))
        else:
            cases.append(("delta", delta.index.store,
                          host_plan(delta.index, qs, "adaptive")))
    return refine_plan_checks("net", qs, k, cases)


def serve_queue(eng, q_np, k):
    """``q_np`` through the engine's queue (``submit_request`` then one
    ``step`` per tick, so ``_after_tick`` runs); returns (dist, gid, host ms
    of each tick)."""
    import numpy as np
    import torch
    from repro_torch.serve import QueryRequest
    tickets = [eng.submit_request(QueryRequest(series=q, k=k, request_id=i))
               for i, q in enumerate(q_np)]
    ticks = []
    while eng.queue:
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step()
        ticks.append((time.perf_counter() - t) * 1e3)
    if not all(t.ok for t in tickets):
        raise SystemExit("fleet: a queued request was not answered")
    return (np.stack([t.result.dist for t in tickets]),
            np.stack([t.result.gid for t in tickets]), ticks)


def sentinel_check(fleet, union, q_np, k, bs) -> dict:
    """The online recall sentinel on the fleet path's traffic: the 256
    queries through ``FleetEngine`` with the sentinel off, then on
    (``sentinel_rate=0.05``, recalibration every 4 audits; two audits after
    each tick), then ``drain()``.  Hard checks: answers bit-equal on and
    off; the audits are the samples that the sentinel's seeded RNG draws
    from the batches handed to ``observe``, and their mean recall equals
    ``recall_at_k`` of those served answers against Dss over ``union``
    (the fleet's rows in global-id order) through the plain
    ``pairwise_l2``."""
    import numpy as np
    import torch
    from repro_torch.eval import recall_at_k
    from repro_torch.fleet import FleetEngine
    from repro_torch.obs import REGISTRY

    kw = dict(batch_size=bs, k=k, routing="signature", fanout=2,
              variant="adaptive", placement="mesh")
    serve_queue(FleetEngine(fleet, **kw), q_np, k)     # every plan cached
    d_off, g_off, ticks_off = serve_queue(FleetEngine(fleet, **kw), q_np, k)
    rate = 0.05
    eng = FleetEngine(fleet, sentinel_rate=rate, sentinel_recalibrate_every=4, **kw)
    sentinel, batches = eng.sentinel, []
    observe = sentinel.observe

    def keep(queries, k_, dist, gid):     # every batch the fleet hands over
        batches.append((queries.copy(), dist.copy(), gid.copy()))
        observe(queries, k_, dist, gid)

    sentinel.observe = keep
    span_hist = REGISTRY.histogram("span.sentinel.audit")
    span_hist.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        d_on, g_on, ticks_on = serve_queue(eng, q_np, k)
        in_ticks = sentinel.snapshot()["audits"]
        pending = sentinel.pending()
        (drained, drain_s) = sync_wall(sentinel.drain)
    finally:
        fleet.sentinel = None
    if not (np.array_equal(d_on, d_off) and np.array_equal(g_on, g_off)):
        raise SystemExit("sentinel: served answers differ with the sentinel on")
    snap = sentinel.snapshot()
    # the samples: the sentinel's RNG (FleetEngine's seed 0) over the batches
    rng = np.random.default_rng(0)
    picks = [(q[i], d[i], g[i]) for q, d, g in batches
             for i in np.nonzero(rng.random(len(q)) < rate)[0]]
    if not picks or snap["audits"] != len(picks):
        raise SystemExit(f"sentinel: {snap['audits']} audits for {len(picks)} "
                         f"sampled queries")
    q_s, d_s, g_s = (np.stack(x) for x in zip(*picks))
    t_d2, t_i = plain_exact_knn(torch.as_tensor(q_s, device=union.device), union, k)
    t_d = torch.sqrt(t_d2).cpu().numpy()
    t_i = t_i.cpu().numpy()
    total = 0.0
    for i in range(len(picks)):           # the sentinel's running sum, in order
        total += recall_at_k(g_s[i:i + 1], t_i[i:i + 1], k, approx_dist=d_s[i:i + 1],
                             exact_dist=t_d[i:i + 1])
    if total / len(picks) != snap["online_recall"]:
        raise SystemExit(f"sentinel: online recall {snap['online_recall']} != "
                         f"{total / len(picks)} against the plain Dss")
    out = {"sample_rate": rate, "recalibrate_every": 4, "queries": len(q_np),
           "audits": snap["audits"],
           "audits_in_ticks": in_ticks, "pending_after_ticks": pending,
           "drained": drained, "online_recall": snap["online_recall"],
           "last_threshold": snap["last_threshold"],
           "audit_ms_mean": span_hist.sum / span_hist.count,
           "audit_ms_p50": span_hist.quantile(0.5),
           "audit_ms_max": span_hist.quantile(1.0),
           "drain_ms_per_audit": drain_s * 1e3 / max(drained, 1),
           "tick_ms_off": float(np.mean(ticks_off)),
           "tick_ms_on": float(np.mean(ticks_on)),
           "tick_ms_on_max": float(np.max(ticks_on)),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    say("fleet sentinel: " + json.dumps(out, default=float)
        + "; answers bit-equal with the sentinel on and off; the audited "
        "queries are the seeded draws and their mean recall == recall_at_k "
        "against the plain Dss")
    return out


def net_client(port, queries, k, name, pipelined, ready, go, out) -> None:
    """One client process of the net path: connect, report ready, wait for
    ``go``, then send ``queries`` as one pipelined ``query_batch`` (resent
    whole on ``RetryLater``) or one at a time (each retried on
    ``RetryLater``).  Puts its answers, per-request round trips (what its
    ``net.rtt_ms`` histogram observes) and wall-clock window on ``out``."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.serve.net import ClimberClient, RetryLater
    try:
        with ClimberClient("127.0.0.1", port, client_name=name, timeout=300) as c:
            ready.put(name)
            if not go.wait(timeout=600):
                raise TimeoutError("no go signal")
            got, rtt, refused = [], [], 0
            begin = time.time()
            for batch in ([list(queries)] if pipelined else [[q] for q in queries]):
                while True:
                    t = time.perf_counter()
                    try:
                        replies = c.query_batch(batch, k=k)
                        break
                    except RetryLater as exc:
                        refused += 1
                        time.sleep(max(exc.retry_after_ms, 1.0) / 1e3)
                rtt.append((time.perf_counter() - t) * 1e3 / len(batch))
                got += replies
            out.put({"name": name, "begin": begin, "end": time.time(),
                     "dist": np.stack([r.dist for r in got]),
                     "gid": np.stack([r.gid for r in got]),
                     "rtt_ms": rtt, "retry_later": refused})
    except Exception as exc:          # reported to the parent, which fails
        ready.put(name)
        out.put({"name": name, "error": f"{type(exc).__name__}: {exc}"})


def net_path(fleet, q_np, k, bs, report) -> dict:
    """The network plane on the fleet path's fleet (module docstring, item
    4).  The clients run in processes of their own, as a deployment's
    would.  Every hard check raises.  Returns the path's launch counts,
    read after the server stopped and before the reference answers are
    computed."""
    import multiprocessing
    import numpy as np
    import torch
    from repro_torch.fleet import FleetEngine
    from repro_torch.kernels import ops
    from repro_torch.obs import REGISTRY
    from repro_torch.obs.registry import Histogram
    from repro_torch.serve.net import ClimberClient, serve_in_thread

    out = report.setdefault("net", {})
    ctx = multiprocessing.get_context("spawn")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eng = FleetEngine(fleet, batch_size=bs, k=k, routing="signature", fanout=2)
    # admission sized for the whole pipelined batch (no refusal possible)
    server, stop = serve_in_thread(eng, config=eng.config.replace(
        max_pending=len(q_np), admission_depth=len(q_np)))
    rejected0 = REGISTRY.counter("net.rejected").value
    answers, phases = {}, {}

    def run_clients(label, specs):
        """Start one process per (name, rows, pipelined), release them
        together, collect their results; every process is joined."""
        ready, go, results = ctx.Queue(), ctx.Event(), ctx.Queue()
        procs = [ctx.Process(target=net_client, daemon=True, args=(
            server.port, q_np[rows], k, name, pipe, ready, go, results))
            for name, rows, pipe in specs]
        ticks0, tick_s0, got = eng.stats.ticks, eng.stats.total_s, []
        try:
            for proc in procs:
                proc.start()
            for _ in procs:
                ready.get(timeout=300)
            go.set()
            got = [results.get(timeout=600) for _ in procs]
        finally:
            for proc in procs:
                proc.join(timeout=60)
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
        errors = [r["error"] for r in got if "error" in r]
        if errors or len(got) != len(procs):
            raise SystemExit(f"net: {label} clients failed: {errors}")
        by_name = {r["name"]: r for r in got}
        for name, rows, _ in specs:
            for j, i in enumerate(rows):
                answers[label, int(i)] = (by_name[name]["dist"][j],
                                          by_name[name]["gid"][j])
        hist = Histogram()
        for r in got:
            for v in r["rtt_ms"]:
                hist.observe(v)
        secs = max(r["end"] for r in got) - min(r["begin"] for r in got)
        ticks = eng.stats.ticks - ticks0
        nq = sum(len(rows) for _, rows, _ in specs)
        phases[label] = {"clients": len(specs), "queries": nq, "seconds": secs,
                         "qps": nq / secs, "ticks": ticks,
                         "mean_batch_fill": nq / (ticks * bs) if ticks else 0.0,
                         "tick_ms_mean": (eng.stats.total_s - tick_s0) * 1e3 / ticks
                         if ticks else 0.0,
                         "client_rtt_ms_p50": hist.quantile(0.5),
                         "client_rtt_ms_p99": hist.quantile(0.99),
                         "client_retries": sum(r["retry_later"] for r in got)}

    try:
        idx = np.arange(len(q_np))
        run_clients("pipelined", [("smoke-pipelined", idx, True)])
        run_clients("concurrent", [(f"smoke-client{w}", idx[w::4], False)
                                   for w in range(4)])
        with ClimberClient("127.0.0.1", server.port, client_name="smoke-admin",
                           timeout=300) as c:
            page, traces, health = c.metrics(), c.traces(), c.health()
        lat = REGISTRY.histogram("serve.latency_ms", loop=eng.obs_label)
        out.update({
            "queries": 2 * len(q_np), "batch_size": bs, "max_pending": len(q_np),
            "admission_depth": len(q_np),
            "flush_interval_ms": eng.config.flush_interval_ms, "phases": phases,
            "serve_latency_ms_p50": lat.quantile(0.5),
            "serve_latency_ms_p99": lat.quantile(0.99),
            "overlap_admissions": server.overlap_admissions,
            "retry_later_replies": REGISTRY.counter("net.rejected").value - rejected0,
            "health": health, "flight_traces": len(traces),
            "metrics_page_bytes": len(page)})
    finally:
        stop()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    if server._exec_thread.is_alive() or server._pending:
        raise SystemExit(f"net: server did not drain ({server._pending} pending)")
    for series in ("repro_fleet_online_recall", "repro_net_queries_total",
                   "repro_net_connections_total", "repro_net_frames_in_total"):
        if series not in page:
            raise SystemExit(f"net: the metrics page has no {series}")
    if health["ready"] != 1 or health["shards"] != len(fleet.shards):
        raise SystemExit(f"net: bad health card {health}")
    d_ref, g_ref = [], []
    for a in range(0, len(q_np), bs):
        d, g, _ = fleet.query(q_np[a:a + bs], k, routing="signature", fanout=2,
                              variant="adaptive")
        d_ref.append(d)
        g_ref.append(g)
    d_ref, g_ref = np.concatenate(d_ref), np.concatenate(g_ref)
    if len(answers) != 2 * len(q_np):
        raise SystemExit(f"net: {len(answers)} answers for {2 * len(q_np)} queries")
    for (label, i), (d, g) in answers.items():
        if not (np.array_equal(d, d_ref[i]) and np.array_equal(g, g_ref[i])):
            raise SystemExit(f"net: {label} answer {i} differs from IndexFleet.query")
    out["launches"] = launches
    say("net: " + json.dumps(out, default=float) + f"; {len(answers)} socket answers "
        "bit-equal to IndexFleet.query; the server drained and stopped")
    say(f"net-path launches: {launches}")
    missing = [name for name in FLEET_KERNELS if launches[name] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the net path: {missing}")
    out["refine_checks"] = net_refine_checks(
        fleet, torch.as_tensor(q_np[:2], device=fleet.device), k)
    return launches


def fleet_path(args, dev, cfg, report):
    """The fleet path (module docstring, item 3), then the network path on
    its fleet (item 4).  Every hard check raises.  Returns the two paths'
    launch counts and the fleet (the mesh path runs on it)."""
    import numpy as np
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.eval import perturbed_queries, recall_at_k, tenant_corpus
    from repro_torch.fleet import (FleetConfig, FleetEngine, IndexFleet,
                                   MergePolicy)
    from repro_torch.kernels import ops
    from repro_torch.serve import QueryRequest

    k, nq, bs = cfg.k, args.queries, 64
    out = report.setdefault("fleet", {})
    # what the card holds as the path starts (the serve index the mesh
    # path reuses): the path's peaks below include it
    out["resident_at_start_gb"] = torch.cuda.memory_allocated() / 1e9
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()

    # ---- shards: one tenant each ---------------------------------------
    t = time.perf_counter()
    corpus = tenant_corpus("seismic", num_shards=FLEET_TENANTS,
                           shard_size=args.fleet_shard, series_len=cfg.series_len,
                           seed=args.seed + 11, affinity=0.6, device=dev)
    queries = perturbed_queries(corpus, nq, noise=0.1, seed=args.seed + 11)
    warm = perturbed_queries(corpus, bs, noise=0.1, seed=args.seed + 12)
    n_ins = (INSERT_BATCHES + TAIL_BATCHES) * INSERT_ROWS
    inserts = perturbed_queries(corpus, n_ins, noise=0.1,
                                seed=args.seed + 13).cpu().numpy()
    union = corpus.union
    torch.cuda.synchronize()
    out["datagen_s"] = time.perf_counter() - t
    seal_at = INSERT_BATCHES * INSERT_ROWS // 2          # two seals under load
    fleet = IndexFleet(FleetConfig(shard_cfg=cfg, fanout=2, delta_capacity=seal_at,
                                   background_compaction=True), device=dev)
    shards = []
    for i, block in enumerate(corpus.shards):
        (h, secs) = sync_wall(lambda: fleet.add_shard(f"tenant{i}", block))
        st = h.index.store
        row = {"key": h.key, "records": h.num_records, "build_s": secs,
               "P": st.num_partitions, "cap": st.capacity,
               "store_gb": sum(x.numel() * x.element_size() for x in st) / 1e9,
               "steps_s": {a: round(b, 3) for a, b in h.index.build_seconds.items()}}
        shards.append(row)
        say(f"fleet shard[{h.key}]: " + json.dumps(
            {a: (round(b, 3) if isinstance(b, float) else b) for a, b in row.items()}))
    out["shards"] = shards
    del corpus, block, h, st
    fleet.attach_mesh([dev])
    q_np = queries.cpu().numpy()

    # stage_ms of every fleet.query call the engines make
    stage_acc = {}
    fleet_query = fleet.query

    def timed_query(*a, **kw):
        d, g, info = fleet_query(*a, **kw)
        for name, v in info.stage_ms.items():
            stage_acc[name] = stage_acc.get(name, 0.0) + v
        return d, g, info

    fleet.query = timed_query

    # ---- serving: host loop and the stacked pass ------------------------
    truth = [fleet.scan_exact(q_np[a:a + bs]) for a in range(0, nq, bs)]
    t_d, t_i = (np.concatenate(x) for x in zip(*truth))
    serve, answers = {}, {}
    for placement in ("host", "mesh"):
        eng = FleetEngine(fleet, batch_size=bs, k=k, routing="signature", fanout=2,
                          variant="adaptive", placement=placement)
        eng.run(warm.cpu().numpy())                            # warm-up tick
        row = {}
        for label in ("cold", "cached"):      # every plan new, then all cached
            eng.reset_metrics()
            stage_acc.clear()
            torch.cuda.synchronize()
            (d, g, metrics), secs = sync_wall(lambda: eng.run(q_np))
            st = eng.stats
            row[label] = {
                "tick_ms": st.total_s / st.ticks * 1e3, "qps": st.queries_per_sec,
                "stage_ms": {a: b / st.ticks for a, b in stage_acc.items()},
                "plan_cache_hit_rate": st.plan_cache_hit_rate,
                "mean_partitions_touched": st.mean_partitions_touched,
                "mean_candidates_scanned": st.mean_candidates_scanned,
                "fanout_savings": fleet.stats.fanout_savings,
                "recall_at_k": recall_at_k(g, t_i, k, approx_dist=d, exact_dist=t_d)}
            answers[placement, label] = (d, g)
        serve[placement] = row
        say(f"fleet serve[{placement}]: " + json.dumps(row, default=float))
    for label in ("cold", "cached"):
        (dh, gh), (dm, gm) = answers["host", label], answers["mesh", label]
        if not (np.array_equal(dh, dm) and np.array_equal(gh, gm)):
            raise SystemExit(f"fleet: host and mesh answers differ ({label})")
    say(f"fleet: host == mesh on {nq} queries, cold and cached (dist and gid bit-equal)")
    out["serve"] = serve

    # ---- exact fan-out ≡ scan_exact ≡ Dss --------------------------------
    q64 = queries[:bs].contiguous()
    tol = 1e-5 * ((q64.double() ** 2).sum(-1, keepdim=True) + float(
        max(float(s.index.store.norms.max()) for s in fleet.shards)))
    d_ex, g_ex, _ = fleet.query(q_np[:bs], k, routing="exhaustive", variant="exhaustive")
    sq = lambda d: torch.as_tensor(d, device=dev).double() ** 2
    gi = lambda g: torch.as_tensor(g, device=dev)
    e1, n1 = assert_same_topk("fleet exhaustive fan-out vs scan_exact", sq(d_ex), gi(g_ex),
                              sq(t_d[:bs]), gi(t_i[:bs]), tol)
    (d_ss, i_ss), dss_s = sync_wall(lambda: exact_knn(q64, union, k, chunk=SCAN_CHUNK))
    e2, n2 = assert_same_topk("fleet scan_exact vs Dss", sq(t_d[:bs]), gi(t_i[:bs]),
                              d_ss.double() ** 2, i_ss, tol)
    out["exact"] = {"fanout_vs_scan_max_abs_err": e1, "fanout_vs_scan_gid_queries": n1,
                    "scan_vs_dss_max_abs_err": e2, "scan_vs_dss_gid_queries": n2,
                    "dss_s": dss_s}
    say(f"fleet: exhaustive fan-out == scan_exact (max |Δd²| {e1:.3g}, {n1} queries "
        f"reorder at ties) == Dss (max |Δd²| {e2:.3g}, {n2} queries) on {bs} queries")
    del d_ss, i_ss

    # ---- the online recall sentinel on the same traffic ----------------
    peak_pre = torch.cuda.max_memory_allocated()       # the sentinel resets it
    out["sentinel"] = sentinel_check(fleet, union, q_np, k, bs)
    del union

    # ---- ingest under load: WAL, background seals, ticks ---------------
    (ROOT / "build").mkdir(exist_ok=True)
    storage = Path(tempfile.mkdtemp(prefix="smoke_fleet_", dir=ROOT / "build"))
    try:
        (_, attach_s) = sync_wall(lambda: fleet.attach_storage(storage))
        eng = FleetEngine(fleet, batch_size=bs, k=k, routing="signature", fanout=2,
                          variant="adaptive", placement="mesh", maintenance_every=1)
        ins_s, ticks, inflight, read_err = 0.0, [], [], 0.0
        for b in range(INSERT_BATCHES):
            rows = inserts[b * INSERT_ROWS:(b + 1) * INSERT_ROWS]
            t = time.perf_counter()
            gids = fleet.insert(rows)
            ins_s += time.perf_counter() - t
            if b >= INSERT_BATCHES - 8:       # acknowledged rows read back at once
                dr, gr, _ = fleet_query(rows[:8], k, variant="exhaustive")
                for i in range(8):
                    hit = gr[i] == gids[i]
                    q2 = float((rows[i].astype(np.float64) ** 2).sum())
                    if not hit.any() or float(dr[i][hit][0]) ** 2 > 1e-5 * 2 * q2:
                        raise SystemExit(f"fleet: acknowledged row {gids[i]} does not "
                                         f"read back at distance 0")
                    read_err = max(read_err, float(dr[i][hit][0]) ** 2)
            ticket = fleet._seal_ticket
            sealing = ticket is not None and not ticket.done()
            for i in range(bs):
                eng.submit_request(QueryRequest(series=q_np[i], k=k, request_id=i))
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.step()
            ticks.append((time.perf_counter() - t) * 1e3)
            if sealing:
                inflight.append(ticks[-1])
        ticket = fleet._seal_ticket
        if ticket is not None:
            ticket.wait()
        if fleet.stats.compactions != 2 or not inflight:
            raise SystemExit(f"fleet: {fleet.stats.compactions} seals, {len(inflight)} "
                             f"ticks during a seal (expected 2 seals, some in flight)")
        ingest = {"rows": INSERT_BATCHES * INSERT_ROWS, "insert_s": ins_s,
                  "acked_rows_per_s": INSERT_BATCHES * INSERT_ROWS / ins_s,
                  "attach_storage_s": attach_s,
                  "compactions": fleet.stats.compactions,
                  "compaction_ms": fleet.stats.compaction_ms,
                  "delta_rebuilds": fleet.stats.delta_rebuilds,
                  "wal_bytes_appended": fleet.wal.appended_bytes,
                  "tick_ms_mean": float(np.mean(ticks)),
                  "tick_ms_during_seal_mean": float(np.mean(inflight)),
                  "ticks_during_seal": len(inflight),
                  "tick_ms_max": float(np.max(ticks)),
                  "readback_max_d2": read_err,
                  "plan_cache_hit_rate": eng.stats.plan_cache_hit_rate,
                  "shards": [s.key for s in fleet.shards]}
        for b in range(INSERT_BATCHES, INSERT_BATCHES + TAIL_BATCHES):    # WAL tail
            fleet.insert(inserts[b * INSERT_ROWS:(b + 1) * INSERT_ROWS])
        ingest["wal_bytes_pending"] = fleet.stats.wal_bytes
        out["ingest"] = ingest
        say("fleet ingest: " + json.dumps(ingest, default=float))

        # ---- restart: save, open into a new fleet, replay the WAL --------
        live_d, live_g, _ = fleet_query(q_np[:bs], k)
        (_, save_s) = sync_wall(lambda: fleet.save())
        (reopened, open_s) = sync_wall(lambda: IndexFleet.open(storage, device=dev))
        re_d, re_g, _ = reopened.query(q_np[:bs], k)
        if not (np.array_equal(re_d, live_d) and np.array_equal(re_g, live_g)):
            raise SystemExit("fleet: answers after restart differ from the live fleet's")
        out["restart"] = {"save_s": save_s, "open_and_replay_s": open_s,
                          "replayed_rows": reopened.delta.occupancy,
                          "shards": len(reopened.shards)}
        say(f"fleet restart: save {save_s:.2f} s, open + WAL replay "
            f"({reopened.delta.occupancy} rows) {open_s:.2f} s; {bs} answers bit-equal")
        del reopened

        # ---- merge the two sealed delta shards ---------------------------
        pre_d, pre_g, _ = fleet_query(q_np[:bs], k, routing="exhaustive",
                                      variant="exhaustive")
        rep_m, merge_s = sync_wall(lambda: fleet.maintenance(MergePolicy(
            small_shard_records=seal_at, max_merged_records=2 * seal_at)))
        if len(rep_m["merged"]) != 1:
            raise SystemExit(f"fleet: maintenance merged {rep_m['merged']}")
        post_d, post_g, _ = fleet_query(q_np[:bs], k, routing="exhaustive",
                                        variant="exhaustive")
        sc_d, sc_g = fleet.scan_exact(q_np[:bs])
        e3, n3 = assert_same_topk("fleet after merge vs scan_exact", sq(post_d),
                                  gi(post_g), sq(sc_d), gi(sc_g), tol)
        e4, n4 = assert_same_topk("fleet after merge vs before", sq(post_d), gi(post_g),
                                  sq(pre_d), gi(pre_g), tol)
        out["merge"] = {"seconds": merge_s, "merged": rep_m["merged"],
                        "shards": [s.key for s in fleet.shards],
                        "vs_scan_max_abs_err": e3, "vs_before_max_abs_err": e4,
                        "vs_before_gid_queries": n4}
        say(f"fleet merge: {rep_m['merged']} in {merge_s:.2f} s; exhaustive answers "
            f"== scan_exact (max |Δd²| {e3:.3g}) and == before the merge "
            f"({n4} queries reorder at ties)")
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        out["launches"] = launches
        out["seconds"] = time.perf_counter() - t_path
        out["peak_memory_gb"] = max(peak_pre, torch.cuda.max_memory_allocated()) / 1e9
        say(f"fleet-path launches: {launches} ({out['seconds']:.1f} s, peak device "
            f"memory {out['peak_memory_gb']:.1f} GB)")
        missing = [name for name in FLEET_KERNELS if launches[name] <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on the fleet path: {missing}")
        out["refine_checks"] = fleet_refine_checks(fleet, q64, k)
        out["peak_memory_gb_with_checks"] = max(
            peak_pre, torch.cuda.max_memory_allocated()) / 1e9
        fleet.query = fleet_query
        net_launches = net_path(fleet, q_np, k, bs, report)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    return launches, net_launches, fleet


MESH_KERNELS = ("paa", "pivot_rank", "refine_topk", "pairwise_l2")
MESH_SLOTS = (3, 4)           # the fleet's meshes; the engine's and Dss's: 4


def mesh_path(args, dev, cfg, report, index, queries, data, fleet):
    """The device mesh (module docstring, item 5) on one card: every slot of
    ``make_mesh(D, devices=[dev] * D)`` is the same card, so the slots take
    views of the stores and run one after another.  The one-device answers
    each mesh run is held to are computed before the launch counts are
    zeroed.  Every hard check raises.  Returns the path's launch counts."""
    import numpy as np
    import torch
    from repro_torch.baselines import exact_knn, exact_knn_sharded
    from repro_torch.core.index import build_index
    from repro_torch.distributed import shard_store, slot_range
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh
    from repro_torch.serve import ClimberEngine

    k, bs = cfg.k, 64
    out = report.setdefault("mesh", {})
    q_np = queries.cpu().numpy()
    nq = len(q_np)
    mesh4 = make_mesh(4, devices=[dev] * 4)
    routings = (("signature", {"routing": "signature", "fanout": 2}),
                ("exhaustive", {"routing": "exhaustive"}))

    def engine_run(**kw):
        eng = ClimberEngine(index, batch_size=bs, variant="adaptive", k=k, **kw)
        eng.run(q_np[:bs])                                  # warm-up tick
        eng.reset_metrics()
        d, g, _ = eng.run(q_np)
        return d, g, eng.stats.total_s / eng.stats.ticks * 1e3

    def fleet_pass(placement):
        """Every routing over the queries in batches of 64, cold then with
        every plan cached: answers, metrics and ms per batch."""
        res = {}
        for name, kw in routings:
            fleet._plan_cache.clear()     # the plans are routing-free: start cold
            for label in ("cold", "cached"):
                parts, ms = [], []
                for a in range(0, nq, bs):
                    (r, secs) = sync_wall(lambda: fleet.query(
                        q_np[a:a + bs], k, variant="adaptive", placement=placement,
                        **kw))
                    parts.append(r)
                    ms.append(secs * 1e3)
                d, g, infos = zip(*parts)
                res[name, label] = (
                    np.concatenate(d), np.concatenate(g),
                    np.concatenate([i.partitions_touched for i in infos]),
                    np.concatenate([i.candidates_scanned for i in infos]),
                    float(np.mean(ms)))
        return res

    # ---- the one-device answers (not counted) ----------------------------
    torch.cuda.synchronize()
    eng_one = engine_run()
    fleet.attach_mesh([dev])                   # the stacked one-slot pass
    host = fleet_pass("host")
    one_slot = fleet_pass("mesh")
    scan_one, scan_one_s = sync_wall(lambda: fleet.scan_exact(q_np[:bs]))
    q64 = queries[:bs].contiguous()
    (dss_one, dss_one_s) = sync_wall(lambda: exact_knn(q64, data, k))

    # ---- the mesh path, launch counts zeroed ------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_path = time.perf_counter()
    eng_mesh = engine_run(mesh=mesh4)
    if not (np.array_equal(eng_mesh[0], eng_one[0])
            and np.array_equal(eng_mesh[1], eng_one[1])):
        raise SystemExit("mesh: the engine on 4 slots differs from one device")
    out["engine"] = {"slots": 4, "queries": nq, "tick_ms_one_device": eng_one[2],
                     "tick_ms_mesh": eng_mesh[2]}
    say(f"mesh engine: 4 slots == one device on {nq} adaptive queries (dist and gid "
        f"bit-equal); tick {eng_mesh[2]:.3f} ms vs {eng_one[2]:.3f} ms")

    fleets = {}
    for d_slots in MESH_SLOTS:
        fleet.attach_mesh(make_mesh(d_slots, devices=[dev] * d_slots))
        res = fleet_pass("mesh")
        pl = fleet._placement
        for key, (d, g, pt, sc, _) in res.items():
            hd, hg, hpt, hsc, _ = host[key]
            if not (np.array_equal(d, hd) and np.array_equal(g, hg)
                    and np.array_equal(pt, hpt) and np.array_equal(sc, hsc)):
                raise SystemExit(f"mesh: the fleet on {d_slots} slots differs from "
                                 f"the host loop ({key})")
        fleets[d_slots] = {
            "shards": pl.num_shards, "num_slots": pl.num_slots,
            "shards_per_slot": [len(s_.shards) for s_ in pl._slots],
            "batch_ms": {f"{a} {b}": v[4] for (a, b), v in res.items()}}
        say(f"mesh fleet D={d_slots}: {pl.num_shards} shards padded to "
            f"{pl.num_slots} slots == host loop on {nq} queries, signature fan-out 2 "
            f"and exhaustive, cold and cached (dist, gid, partitions_touched, "
            f"candidates_scanned bit-equal); " + json.dumps(fleets[d_slots]))
    out["fleet"] = fleets
    out["fleet_one_slot_batch_ms"] = {f"{a} {b}": v[4] for (a, b), v in one_slot.items()}
    out["fleet_host_batch_ms"] = {f"{a} {b}": v[4] for (a, b), v in host.items()}

    scan_mesh, scan_mesh_s = sync_wall(lambda: fleet.scan_exact(q_np[:bs], mesh=mesh4))
    if not all(np.array_equal(a, b) for a, b in zip(scan_mesh, scan_one)):
        raise SystemExit("mesh: scan_exact on 4 slots differs from one device")
    out["scan_exact"] = {"ms_one_device": scan_one_s * 1e3, "ms_mesh": scan_mesh_s * 1e3}
    say(f"mesh scan_exact: 4 slots == one device on {bs} queries (bit-equal); "
        f"{scan_mesh_s * 1e3:.1f} ms vs {scan_one_s * 1e3:.1f} ms")

    (dss_mesh, dss_mesh_s) = sync_wall(lambda: exact_knn_sharded(q64, data, k,
                                                                  mesh=mesh4))
    tol = 1e-5 * ((q64.double() ** 2).sum(-1, keepdim=True)
                  + float((data[:1 << 16].double() ** 2).sum(-1).max()))
    err, differ = assert_same_topk("exact_knn_sharded vs exact_knn",
                                   dss_mesh[0].double() ** 2, dss_mesh[1],
                                   dss_one[0].double() ** 2, dss_one[1], tol)
    bit_equal = bool(torch.equal(dss_mesh[0], dss_one[0])
                     and torch.equal(dss_mesh[1], dss_one[1]))
    out["exact_knn"] = {"rows": data.shape[0], "queries": bs, "max_abs_err": err,
                        "gid_queries_differ": differ, "bit_equal": bit_equal,
                        "ms_one_device": dss_one_s * 1e3, "ms_mesh": dss_mesh_s * 1e3}
    say(f"mesh exact_knn_sharded: 4 slots vs exact_knn over {data.shape[0]} series, "
        f"{bs} queries: max |Δd²| {err:.3g}, {differ} queries reorder at ties, "
        f"bit-equal {bit_equal}; {dss_mesh_s * 1e3:.1f} ms vs {dss_one_s * 1e3:.1f} ms")

    # one max-min build of one fleet shard's size, beside a random one
    rows = data[:args.fleet_shard]
    builds = {}
    for method in ("random", "maxmin"):
        g_b = torch.Generator(device=dev).manual_seed(args.seed + 21)
        ix, secs = sync_wall(lambda: build_index(rows, cfg, device=dev, generator=g_b,
                                                 pivot_method=method))
        gid = ix.store.rec_gid
        live = torch.sort(gid[gid >= 0]).values
        if not torch.equal(live, torch.arange(rows.shape[0], device=dev,
                                              dtype=live.dtype)):
            raise SystemExit(f"mesh: the {method} build does not store every "
                             f"record exactly once")
        builds[method] = {"seconds": secs, "P": ix.store.num_partitions,
                          "cap": ix.store.capacity, "G": ix.num_groups,
                          "steps_s": {a: round(b, 3)
                                      for a, b in ix.build_seconds.items()}}
        del ix, gid, live
    out["builds"] = builds
    say(f"mesh build options: {rows.shape[0]} series, every record stored once "
        f"by both; " + json.dumps(builds, default=float))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_path
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"mesh-path launches: {launches} ({out['seconds']:.1f} s, peak device memory "
        f"{out['peak_memory_gb']:.1f} GB)")
    missing = [name for name in MESH_KERNELS if launches[name] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the mesh path: {missing}")

    # refine_topk against its plain version on one slot's plans: the
    # engine's slot 1 of 4 and the fleet's slot 1 of 4 (its first shard)
    qp = host_plan(index, q64, "adaptive")
    lo, hi = slot_range(index.store.num_partitions, 4, 1)
    sp_local = torch.where((qp[0] >= lo) & (qp[0] < hi), qp[0] - lo, -1)
    slot_store = shard_store(index.store, mesh4)[1]
    pl = fleet._placement
    j = pl._slots[1].shards[0]
    fqp = pl.plan_shard(j, ops.paa(q64, cfg.paa_segments), "adaptive")
    out["refine_checks"] = refine_plan_checks("mesh", q64, k, (
        ("engine slot 1 of 4", slot_store, (sp_local, qp[1], qp[2])),
        (f"fleet slot 1 of 4, shard {fleet.shards[j].key}",
         pl._slots[1].stores[0], (fqp.sel_part, fqp.sel_lo, fqp.sel_hi))))
    return launches


def frontier_path(args, dev, cfg, report) -> dict:
    """The recall frontier (module docstring, item 5): ``run_frontier`` at
    ``ClimberConfig()`` over two datasets at 1 and 4 shards, then its hard
    checks, the last of which re-answers the seismic × 4 sweep's queries
    through a fresh evaluation fleet with exhaustive routing and the
    exhaustive planner against Dss through the plain ``pairwise_l2``, and
    holds both kernels the sweep's queries and ground truth ran through
    against their plain versions at the sweep's shapes.  Every hard check
    raises.  Returns the path's launch counts (read before those checks)."""
    import dataclasses
    import inspect
    import numpy as np
    import torch
    from repro_torch.core.query import register_recall_target
    from repro_torch.eval import (FrontierSpec, GroundTruthCache, build_eval_fleet,
                                  perturbed_queries, tenant_corpus)
    from repro_torch.kernels import ops

    class SmokeFrontierSpec(FrontierSpec):
        """The sweep at the paper's configuration: every shard is
        ``ClimberConfig()`` (the package's spec keeps the JAX package's
        small shard config)."""

        def shard_cfg(self):
            return cfg

    spec = SmokeFrontierSpec(
        datasets=("randomwalk", "seismic"), shard_counts=(1, 4),
        shard_size=args.frontier_shard, series_len=cfg.series_len,
        num_queries=EVAL_QUERIES, num_calibration=32, k=cfg.k, seed=args.seed)
    out = report.setdefault("frontier", {"spec": dataclasses.asdict(spec)})
    (ROOT / "build").mkdir(exist_ok=True)
    gt_dir = Path(tempfile.mkdtemp(prefix="smoke_frontier_gt_", dir=ROOT / "build"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        from repro_torch.eval import run_frontier
        t = time.perf_counter()
        doc = run_frontier(spec, cache_dir=gt_dir, device=dev,
                           progress=lambda m: say(f"frontier: {m} "
                                                  f"({time.perf_counter() - t:.1f} s)"))
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        out["seconds"] = time.perf_counter() - t
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["ground_truth_cache"] = doc["ground_truth_cache"]
        cells = doc["cells"]
        out["cells"], out["frontiers"], out["routed_gap"] = \
            cells, doc["frontiers"], doc["routed_gap"]
        say(f"frontier-path launches: {launches} ({out['seconds']:.1f} s, peak "
            f"device memory {out['peak_memory_gb']:.1f} GB)")
        missing = [name for name in FLEET_KERNELS + ("pairwise_l2",)
                   if launches[name] <= 0]
        if missing:
            raise SystemExit(f"kernels not launched on the frontier path: {missing}")

        # ---- report: per dataset and shard count -------------------------
        for ds in spec.datasets:
            for shards in spec.shard_counts:
                total = shards * spec.shard_size
                mine = [c for c in cells if c.get("dataset") == ds
                        and c.get("shards") == shards and "recall" in c]
                row = {"learned": [c["param"] for c in mine
                                   if c["param"].startswith("learned=")][:1],
                       "spend": {c["param"]: {"recall": c["recall"],
                                              "frac_scanned": c["mean_candidates_scanned"]
                                              / total,
                                              "partitions": c["mean_partitions_touched"]}
                                 for c in mine if c["variant"] == "recall_target"
                                 and c["split"] == "all"},
                       "slot_budget": {c["slot_budget"]: {
                           "recall": c["recall"],
                           "partitions": c["mean_partitions_touched"]}
                           for c in mine if c["slot_budget"] and c["split"] == "all"},
                       "exhaustive_routing_recall": {
                           c["split"]: c["recall"] for c in mine
                           if c["routing"] == "exhaustive" and c["param"] == "-"
                           and not c["slot_budget"]},
                       "auc": {f["split"]: {"fixed": f["fixed_auc"],
                                            "adaptive": f["adaptive_auc"]}
                               for f in doc["frontiers"] if f["dataset"] == ds
                               and f["shards"] == shards},
                       "routed_gap": [
                           {a: g[a] for a in ("split", "param", "frac_scanned",
                                              "adaptive_recall", "fixed_recall_at_cost",
                                              "improvement")}
                           for g in doc["routed_gap"] if g["dataset"] == ds
                           and g["shards"] == shards and g["split"] == "all"]}
                say(f"frontier[{ds} x {shards}]: " + json.dumps(row, default=float))

        # ---- hard checks on the cells --------------------------------------
        for c in cells:
            if "recall" not in c:
                continue
            if not (0.0 <= c["recall"] <= 1.0 and np.isfinite(c["map"])):
                raise SystemExit(f"frontier: malformed cell {c}")
            if c["slot_budget"] and \
                    c["mean_partitions_touched"] > c["slot_budget"] * c["shards"]:
                raise SystemExit(f"frontier: slot budget {c['slot_budget']} touched "
                                 f"{c['mean_partitions_touched']} partitions")
        for exh in (c for c in cells if c.get("routing") == "exhaustive"
                    and c.get("param") == "-" and c.get("slot_budget") == 0):
            routed = [c for c in cells if "routing" in c and c["routing"] != "exhaustive"
                      and (c["dataset"], c["shards"], c["split"])
                      == (exh["dataset"], exh["shards"], exh["split"])]
            over = [c for c in routed
                    if c["mean_candidates_scanned"] > exh["mean_candidates_scanned"]]
            if over:
                raise SystemExit(f"frontier: routed cells scan more than exhaustive "
                                 f"routing: {over}")
        say("frontier: exhaustive routing scans at least as much as every routed "
            "cell; every slot budget b keeps to at most b x shards partitions")

        # ---- the exhaustive ceiling ≡ the plain Dss ------------------------
        # seismic x 4 again, outside the counts: its first Dss chunk through
        # pairwise_l2 and its plain version, the sweep's cached ground truth
        # and a fresh fleet's exhaustive answers against Dss through the
        # plain pairwise_l2, and refine_topk against its plain version on
        # shard 0's exhaustive and spend-4 plans
        ds, shards, k = "seismic", 4, spec.k
        corpus = tenant_corpus(ds, num_shards=shards, shard_size=spec.shard_size,
                               series_len=spec.series_len, seed=spec.seed,
                               affinity=spec.affinity, device=dev)
        qs = perturbed_queries(corpus, spec.num_queries, noise=spec.noise,
                               seed=spec.seed)
        meta = dict(corpus.meta(), num_queries=spec.num_queries, noise=spec.noise,
                    qseed=spec.seed)
        cached = GroundTruthCache(gt_dir).get(dict(meta, k=2 * k))
        if cached is None:
            raise SystemExit("frontier: the sweep's ground truth is not in its cache")
        union = corpus.union
        # the rows of one Dss launch of the sweep's ground truth
        chunk = union[:inspect.signature(GroundTruthCache.exact).parameters["chunk"].default]
        l2_err = l2_check("pairwise_l2 [frontier Dss chunk]", qs, chunk)
        out["l2_check"] = {"shape": f"[{qs.shape[0]},{qs.shape[1]}] x "
                                    f"[{chunk.shape[0]},{chunk.shape[1]}]",
                           "max_abs_err": l2_err}
        say(f"pairwise_l2 [frontier Dss chunk]: max |Δd²| {l2_err:.3g} over "
            f"{out['l2_check']['shape']}")
        p_d2, p_i = plain_exact_knn(qs, union, 2 * k)
        tol = 1e-5 * ((qs.double() ** 2).sum(-1, keepdim=True)
                      + float((union * union).sum(-1).max()))
        del union, chunk
        fleet = build_eval_fleet(corpus, spec, device=dev)
        del corpus
        sq = lambda d: torch.as_tensor(d, device=dev).double() ** 2
        gi = lambda g: torch.as_tensor(g, device=dev)
        gt_err, gt_tie = assert_same_topk("frontier cached Dss vs plain Dss",
                                          sq(cached[0]), gi(cached[1]),
                                          p_d2.double(), p_i, tol)
        q_np = qs.cpu().numpy()
        d_ex, g_ex, info = fleet.query(q_np, k, routing="exhaustive",
                                       variant="exhaustive")
        err, n_tie = assert_same_topk("frontier exhaustive ceiling vs plain Dss",
                                      sq(d_ex), gi(g_ex), p_d2[:, :k].double(),
                                      p_i[:, :k], tol)
        _, _, info_a = fleet.query(q_np, k, routing="exhaustive")
        exh_all = next(c for c in cells if (c.get("dataset"), c.get("shards"),
                                           c.get("split"), c.get("routing"),
                                           c.get("param"), c.get("slot_budget"))
                       == (ds, shards, "all", "exhaustive", "-", 0))
        if float(info_a.candidates_scanned.mean()) != exh_all["mean_candidates_scanned"]:
            raise SystemExit("frontier: a fresh fleet scans differently from the sweep's")
        out["exhaustive_ceiling"] = {"max_abs_err": err, "gid_queries_differ": n_tie,
                                     "cached_gt_max_abs_err": gt_err,
                                     "cached_gt_gid_queries_differ": gt_tie,
                                     "candidates_scanned": float(
                                         info.candidates_scanned.mean())}
        say(f"frontier: seismic x 4, the sweep's cached Dss (2k = {2 * k}) == Dss "
            f"through the plain pairwise_l2 (max |Δd²| {gt_err:.3g}, {gt_tie} queries "
            f"reorder at ties); exhaustive routing + exhaustive planner == the plain "
            f"Dss (max |Δd²| {err:.3g}, {n_tie} of {len(q_np)} queries reorder at "
            f"k-th-distance ties); a fresh fleet scans as the sweep did")
        del p_d2, p_i
        h = fleet.shards[0]
        register_recall_target(4.0)
        out["refine_checks"] = refine_plan_checks("frontier", qs, k, [
            (f"{label}, shard {h.key}", h.index.store, host_plan(h.index, qs, variant))
            for label, variant in (("exhaustive", "exhaustive"),
                                   ("spend 4", "recall_target"))])
        del fleet
    finally:
        shutil.rmtree(gt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


LM_KERNELS = ("paa", "pivot_rank", "refine_topk", "pairwise_l2")
LM_ARCH = "internlm2-1.8b"                      # the engine's and the kNN-LM's model
# depths cut to fit one card's 80 GB at bf16 (the other archs run in full)
LM_DEPTH = {"mistral-large-123b": 4,            # of 88 layers
            "llama-3.2-vision-90b": 10}         # of 100: 2 groups of 5
LM_SLOTS, LM_MAX_LEN, LM_REQUESTS, LM_NEW = 8, 512, 32, 32
LM_DS_BATCH, LM_DS_SEQ = 16, 1024               # datastore pipeline
# 32 of the 64 steps (2^20 rows) the example's scale would take: the store
# pads every partition to the fullest, and these hidden states route
# skewed (at 1,047,552 rows: 4,106 partitions of mean 255 rows, the fullest
# 2,760, a 92.8 GB store; at 2^19: 2,059, 1,265, 21.3 GB); 2 in a rehearsal
LM_DS_STEPS, LM_DS_FULL_STEPS, LM_DS_SMOKE_STEPS = 32, 64, 2
LM_QUERIES, LM_CTX, LM_K, LM_LAMBDA, LM_TEMP = 64, 256, 16, 0.25, 1.0
# rows of 256 tokens in each decode-vs-forward check: with 2 (seed 0, on an
# H100), 5 of the 10 archs had no row whose top-1/top-2 gap exceeds 0.3,
# so the bf16 rule tested nothing there
LM_CHECK_ROWS = 8
PREFILL_CHUNK = 64                              # the engine's prefill kv_chunk


def lm_prompt_lengths(gen, n, lo=32, hi=256):
    """``n`` prompt lengths in ``[lo, hi]`` drawn from ``gen``, among the
    lengths the engine's chunked prefill accepts (the reference's
    ``flash_attention`` needs the length divisible by its chunk count,
    ``max(s // 64, 1)``)."""
    import torch
    ok = [s for s in range(lo, hi + 1) if s % max(s // PREFILL_CHUNK, 1) == 0]
    return [ok[int(i)] for i in torch.randint(len(ok), (n,), generator=gen)]


def decode_vs_forward(model, params, batch, label, atol=None):
    """``prefill`` of all but the last token and one ``decode_step`` with
    it, against ``forward`` at that position, by :func:`logits_rule`: bf16
    parameters (``atol=None``) by the greedy rule, fp32 ones also with
    every logit within ``atol·(1+|forward|)``.  Raises; returns the
    numbers."""
    import torch
    from repro_torch.models import decode_step, prefill
    tokens = batch["tokens"]
    s = tokens.shape[1]
    full = model(params, batch)[:, s - 1].float()
    _, cache = prefill(model, params, {**batch, "tokens": tokens[:, :s - 1]},
                       max_len=s)
    got = decode_step(model, params, cache, tokens[:, s - 1:])[0][:, 0].float()
    return {"rows": int(full.shape[0]), "prompt": s,
            **logits_rule(got, full, f"lm [{label}] decode vs forward", atol)}


def logits_rule(got, full, label, atol=None):
    """The lm rules on logits [..., V] against ``full``: finite; the greedy
    token equal wherever ``full``'s top-1/top-2 gap exceeds 0.3 (twice the
    reference test's rtol = atol = 0.15), max |Δ| reported; with ``atol``
    (fp32), every logit within ``atol·(1+|full|)``.  Raises naming
    ``label``; returns the numbers."""
    import torch
    got = got.float().reshape(-1, got.shape[-1])
    full = full.float().reshape(-1, full.shape[-1])
    if not (bool(torch.isfinite(got).all()) and bool(torch.isfinite(full).all())):
        raise SystemExit(f"{label}: non-finite logits")
    delta = (got - full).abs()
    top2 = torch.topk(full, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    clear = gap > 0.3
    same = got.argmax(-1) == full.argmax(-1)
    out = {"positions": int(full.shape[0]), "max_abs_delta": float(delta.max()),
           "max_abs_logit": float(full.abs().max()),
           "rel_err": float((delta / (1 + full.abs())).max()),
           "beyond_0.15": int((delta > 0.15 + 0.15 * full.abs()).sum()),
           "max_gap": float(gap.max()), "gap_over_0.3": int(clear.sum()),
           "argmax_equal": int(same.sum())}
    if atol is not None and not out["rel_err"] <= atol:
        raise SystemExit(f"{label}: |Δ|/(1+|logit|) {out['rel_err']} beyond {atol}")
    if bool((~same & clear).any()):
        raise SystemExit(f"{label}: the greedy token differs where the gap exceeds 0.3")
    return out


FP32_CHECK_BYTES = 24e9         # fp32 weights the decode check runs at full depth


def fp32_decode_check(cfg, batch, gen, dev, label):
    """:func:`decode_vs_forward` at full width in fp32, every logit within
    1e-3·(1+|logit|): at full depth where the fp32 weights take at most
    ``FP32_CHECK_BYTES``, else at the shallowest depth the family has (one
    hybrid or vlm group, else 2 layers and 2 encoder layers)."""
    import torch
    from repro_torch.models import Model, count_params
    scfg = cfg
    if count_params(Model(cfg).infos()) * 4 > FP32_CHECK_BYTES:
        depth = {"hybrid": cfg.hybrid_attn_every, "vlm": cfg.cross_attn_every}
        scfg = cfg.replace(num_layers=depth.get(cfg.family, 2),
                           num_encoder_layers=min(cfg.num_encoder_layers, 2))
    model = Model(scfg)
    params = model.init(gen, dev, dtype=torch.float32)
    batch = {k: v.float() if v.is_floating_point() else v for k, v in batch.items()}
    with torch.no_grad():
        out = decode_vs_forward(model, params, batch, f"{label} fp32", atol=1e-3)
    del params
    torch.cuda.empty_cache()
    return dict(out, layers=scfg.num_layers)


def drain_engine(model, params, prompts, new_tokens, slots, max_len, dev):
    """Requests through ``Engine`` until drained: (engine, requests, wall s)."""
    import numpy as np
    from repro_torch.serve import Engine, Request
    eng = Engine(model, params, slots=slots, max_len=max_len, device=dev)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    _, secs = sync_wall(lambda: eng.run_until_drained(max_ticks=100_000))
    if eng.queue or not all(r.done for r in reqs):
        raise SystemExit("lm: the engine did not drain")
    return eng, reqs, secs


def engine_row(eng, secs):
    st = eng.stats
    return {"requests": st.prefills, "ticks": st.ticks, "tokens": st.tokens,
            "prefill_ms_per_request": st.prefill_s / max(st.prefills, 1) * 1e3,
            "decode_ms_per_tick": st.decode_s / max(st.ticks, 1) * 1e3,
            "generated_tokens_per_s": st.tokens / secs, "seconds": secs}


def lm_path(args, dev, report):
    """The LM serving plane (module docstring, item 7): (a) the engine at
    ``LM_ARCH``'s full config, (c) every other architecture at full width,
    one at a time, then (b) the kNN-LM over CLIMBER on (a)'s hidden states
    (in that order, so that no model shares the card with the datastore and
    its index); after the path's launch counts are read, (d) the four
    kernels it ran against their plain versions at its shapes.  Every hard
    check raises.  Returns the path's launch counts."""
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.core import build_index, knn_query
    from repro_torch.data import TokenPipeline
    from repro_torch.eval import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.kernels.refine_topk import refine_work
    from repro_torch.models import Model, count_params, decode_step, prefill
    from repro_torch.models.params import tree_leaves
    from repro_torch.utils.config import ClimberConfig

    out = report.setdefault("lm", {"arch": LM_ARCH, "smoke_widths": args.lm_smoke})
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    host_gen = torch.Generator().manual_seed(args.seed)
    gb = lambda params: sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_path = time.perf_counter()

    # ---- (a) the engine at full width --------------------------------------
    cfg = get_config(LM_ARCH, smoke=args.lm_smoke)
    model = Model(cfg)
    params, init_s = sync_wall(lambda: model.init(gen, dev))
    out["params"] = count_params(model.infos())
    out["params_gb"] = gb(params)
    say(f"lm: {cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}, vocab "
        f"{cfg.vocab_size}): {out['params']:,} parameters, {out['params_gb']:.2f} GB "
        f"bf16, initialised on the card in {init_s:.2f} s")
    lens = lm_prompt_lengths(host_gen, LM_REQUESTS)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=host_gen).numpy()
               for n in lens]
    # a lone request through the engine ≡ a prefill + decode_step loop
    eng1, (req,), _ = drain_engine(model, params, prompts[:1], LM_NEW, 1,
                                   LM_MAX_LEN, dev)
    with torch.no_grad():
        logits, cache = prefill(model, params, {"tokens": torch.as_tensor(
            prompts[0][None], device=dev)}, max_len=LM_MAX_LEN, kv_chunk=PREFILL_CHUNK)
        loop = [int(torch.argmax(logits[0, -1]))]
        while len(loop) < LM_NEW:
            logits, cache = decode_step(model, params, cache, torch.tensor(
                [[loop[-1]]], dtype=torch.int32, device=dev))
            loop.append(int(torch.argmax(logits[0, -1])))
    if req.generated != loop:
        raise SystemExit(f"lm: a lone request's engine tokens differ from the "
                         f"prefill + decode_step loop ({req.generated} vs {loop})")
    say(f"lm: a lone {lens[0]}-token request through Engine == the prefill + "
        f"decode_step loop, {LM_NEW} greedy tokens")
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, secs = drain_engine(model, params, prompts, LM_NEW, LM_SLOTS,
                                   LM_MAX_LEN, dev)
    if any(len(r.generated) != LM_NEW for r in reqs):
        raise SystemExit("lm: a request stopped short of its new tokens")
    out["engine"] = dict(engine_row(eng, secs), slots=LM_SLOTS, max_len=LM_MAX_LEN,
                         prompt_lengths=lens, new_tokens=LM_NEW,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    say(f"lm engine[{cfg.name}, {LM_SLOTS} slots, max_len {LM_MAX_LEN}]: "
        + json.dumps({a: (round(b, 3) if isinstance(b, float) else b)
                      for a, b in out["engine"].items() if a != "prompt_lengths"}))
    pipe_q = TokenPipeline(cfg, global_batch=LM_CHECK_ROWS, seq_len=256, seed=args.seed,
                           device=dev)
    with torch.no_grad():
        out["decode_vs_forward"] = decode_vs_forward(
            model, params, {"tokens": pipe_q.batch_at(0)["tokens"][:, :256]}, cfg.name)
    out["decode_vs_forward_fp32"] = fp32_decode_check(
        cfg, {"tokens": pipe_q.batch_at(0)["tokens"][:, :256]}, gen, dev, cfg.name)
    say(f"lm: decode_step == forward at the last of 256 positions: bf16 "
        + json.dumps(out["decode_vs_forward"]) + "; fp32 at "
        + json.dumps(out["decode_vs_forward_fp32"]))

    # ---- (c) every other architecture at full width, one at a time ---------
    out["archs"] = {}
    out["reduced"] = {}
    peaks = [torch.cuda.max_memory_allocated() / 1e9]          # (a)
    for arch in ARCHS:
        if arch == LM_ARCH:
            continue
        t = time.perf_counter()
        acfg = get_config(arch, smoke=args.lm_smoke)
        if arch in LM_DEPTH and not args.lm_smoke:
            acfg = acfg.replace(num_layers=LM_DEPTH[arch])
            out["reduced"][arch] = f"{LM_DEPTH[arch]} of {get_config(arch).num_layers} layers"
        # capacity-dropping MoE routes a prompt and its prefill differently
        # beyond 8 tokens (the reference's test holds no MoE arch to this)
        b_rows, s_len = (1, 8) if acfg.family == "moe" else (LM_CHECK_ROWS, 256)
        if acfg.family in ("ssm", "hybrid"):       # a prefill of s - 1 tokens
            s_len = min(s_len, acfg.ssm_chunk)     # is one chunk of SSD
        batch = TokenPipeline(acfg, global_batch=b_rows, seq_len=s_len, seed=args.seed,
                              device=dev).batch_at(0)
        batch["tokens"] = batch["tokens"][:, :s_len]
        # the reference ropes a decoded token's cross-attention query at
        # position 0, the forward's at its own: encdec decode equals forward
        # only without RoPE (ROADMAP queue 3), so its checks run without it
        check_cfg = acfg.replace(use_rope=False) if acfg.family == "encdec" else acfg
        torch.cuda.reset_peak_memory_stats()
        check_fp32 = fp32_decode_check(check_cfg, batch, gen, dev, arch)
        amodel = Model(acfg)
        aparams = amodel.init(gen, dev)
        with torch.no_grad():
            check = decode_vs_forward(Model(check_cfg), aparams, batch, arch)
        plen = 256
        ptoks = TokenPipeline(acfg, global_batch=2, seq_len=plen, seed=args.seed + 1,
                              device=dev).batch_at(0)["tokens"][:, :plen].cpu().numpy()
        # an encdec engine's prompts fill max_len (its cross cache's length)
        max_len = plen if acfg.family == "encdec" else plen + 16
        aeng, areqs, asecs = drain_engine(amodel, aparams, list(ptoks), 8, 2, max_len, dev)
        row = {"family": acfg.family, "layers": acfg.num_layers,
               "params": count_params(amodel.infos()), "params_gb": gb(aparams),
               **engine_row(aeng, asecs),
               "generated": [len(r.generated) for r in areqs],
               "decode_vs_forward": check, "decode_vs_forward_fp32": check_fp32,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "seconds": time.perf_counter() - t}
        out["archs"][arch] = row
        peaks.append(row["peak_memory_gb"])
        say(f"lm arch[{arch}]: " + json.dumps(
            {a: (round(b, 3) if isinstance(b, float) else b) for a, b in row.items()}))
        del amodel, aparams, aeng, batch
        torch.cuda.empty_cache()
    # ---- (b) the kNN-LM over CLIMBER (after (c): its datastore and index
    # stay on the card for (d)) --------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    d = cfg.d_model
    pipe = TokenPipeline(cfg, global_batch=LM_DS_BATCH, seq_len=LM_DS_SEQ,
                         seed=args.seed, device=dev)
    per = LM_DS_BATCH * (LM_DS_SEQ - 1)
    steps = LM_DS_SMOKE_STEPS if args.lm_smoke else LM_DS_STEPS
    rows = steps * per
    datastore = torch.empty((rows, d), dtype=torch.float32, device=dev)
    labels = torch.empty(rows, dtype=torch.int64, device=dev)

    def fill():
        with torch.no_grad():
            for step in range(steps):
                tokens = pipe.batch_at(step)["tokens"][:, :-1]
                hidden = model(params, {"tokens": tokens})[..., :d]   # the example's proxy
                datastore[step * per:(step + 1) * per] = hidden[:, :-1].reshape(-1, d)
                labels[step * per:(step + 1) * per] = tokens[:, 1:].reshape(-1)

    _, ds_s = sync_wall(fill)
    ccfg = ClimberConfig(series_len=d, paa_segments=16, num_pivots=48, prefix_len=6,
                         capacity=256, sample_frac=0.25, max_centroids=24, k=LM_K,
                         candidate_groups=4, adaptive_factor=4)
    index, build_s = sync_wall(lambda: build_index(datastore, ccfg, device=dev,
                                                   generator=gen))
    store = index.store
    store_gb = sum(x.numel() * x.element_size() for x in store) / 1e9
    ctx = TokenPipeline(cfg, global_batch=LM_QUERIES, seq_len=LM_DS_SEQ, seed=args.seed,
                        device=dev).batch_at(99)["tokens"][:, :LM_CTX]
    with torch.no_grad():
        logits = model(params, {"tokens": ctx})[:, -1].float()
    q = logits[:, :d].contiguous()
    knn_query(index, q[:8], LM_K, variant="adaptive")               # warm-up
    (dist, gid, qp), query_s = sync_wall(lambda: knn_query(index, q, LM_K,
                                                           variant="adaptive"))
    # the example's interpolation, its neighbour weights as a softmax over
    # the valid neighbours (exp(-d/T) normalised, without underflow)
    valid = gid >= 0
    w = torch.softmax(torch.where(valid, -dist / LM_TEMP, float("-inf")), dim=-1)
    w = torch.where(valid, w, 0.0)
    p_lm = torch.softmax(logits, dim=-1)
    knn_p = torch.zeros_like(p_lm).scatter_add_(1, labels[gid.clamp(min=0).long()], w)
    mix = (1 - LM_LAMBDA) * p_lm + LM_LAMBDA * knn_p
    sums = mix.sum(-1)
    if not bool(((sums - 1).abs() <= 1e-3).all()):
        raise SystemExit(f"lm: a mixed distribution sums to {float(sums.min())}"
                         f"..{float(sums.max())}")
    # knn_query ≡ the plain refine of the same plan: gids exact, d² within tol
    order = torch.argsort(qp.sel_part, dim=-1, stable=True)
    sp, lo, hi = (torch.gather(x, 1, order).to(torch.int32).contiguous()
                  for x in (qp.sel_part, qp.sel_lo, qp.sel_hi))
    d2_p, g_p, _ = plain_refine_chunked(store, q, sp, lo, hi, LM_K)
    tol = 1e-5 * ((q * q).sum(-1, keepdim=True) + float(store.norms.max()))
    d2_err = (dist.double() ** 2 - d2_p.double()).abs()
    if not torch.equal(gid, g_p) or bool((d2_err > tol).any()):
        raise SystemExit(f"lm: knn_query differs from the plain refine of its plan "
                         f"({int((gid != g_p).any(1).sum())} queries' gids, max "
                         f"|Δd²| {float(d2_err.max())})")
    (d_ex, i_ex), dss_s = sync_wall(lambda: exact_knn(q, datastore, LM_K,
                                                      chunk=SCAN_CHUNK))
    recall = recall_at_k(gid, i_ex, LM_K, approx_dist=dist, exact_dist=d_ex)
    out["knn_lm"] = {
        "datastore_rows": rows, "datastore_gb": rows * d * 4 / 1e9,
        "datastore_forward_s": ds_s, "build_s": index.build_seconds,
        "build_wall_s": build_s, "P": store.num_partitions, "cap": store.capacity,
        "G": index.num_groups, "store_gb": store_gb, "queries": LM_QUERIES,
        "query_ms": query_s * 1e3,
        "neighbours_per_query": float(valid.sum(1).float().mean()),
        "mixed_argmax_differs": float((mix.argmax(-1) != p_lm.argmax(-1)).float().mean()),
        "mixed_sum_max_dev": float((sums - 1).abs().max()),
        "recall_at_16_vs_dss": recall, "dss_ms": dss_s * 1e3,
        "plain_refine_max_abs_d2_err": float(d2_err.max()),
        "mean_partitions_touched": float(qp.partitions_touched().float().mean())}
    say(f"lm knn[{rows} rows x {d}]: " + json.dumps(
        {a: (round(b, 4) if isinstance(b, float) else
             {c: round(e, 3) for c, e in b.items()} if isinstance(b, dict) else b)
         for a, b in out["knn_lm"].items()}))
    say("lm: every mixed distribution sums to 1 within 1e-3; knn_query == the plain "
        "refine of its plan (gids exact)")
    out["reduced"]["knn_lm datastore"] = (
        f"{steps} of {LM_DS_FULL_STEPS} steps ({rows:,} rows): the dense "
        f"store at 2^20 rows is 92.8 GB")
    del params, eng, eng1, cache, logits, p_lm, knn_p, mix

    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out["seconds"] = time.perf_counter() - t_path
    say(f"lm-path launches: {launches} ({out['seconds']:.1f} s)")
    missing = [name for name in LM_KERNELS if launches[name] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the lm path: {missing}")

    # ---- where the recall goes, and (d) the kernels at this path's shapes,
    # both outside the counts -----------------------------------------------
    out["knn_lm"]["recall_split"] = lm_recall_split(index, q, qp, datastore, i_ex, d_ex,
                                                    ccfg.paa_segments)
    say("lm knn recall split: " + json.dumps(out["knn_lm"]["recall_split"]))
    kc = out["kernels"] = {}
    w, m = ccfg.paa_segments, ccfg.prefix_len
    x = datastore[:min(rows, 1 << 18)]
    kc["paa"] = paa_row(x, w)
    kc["pivot_rank"] = pivot_rank_row(ops.paa(x, w), index.pivots, m)
    kc["pivot_rank"]["queries"] = pivot_rank_row(ops.paa(q, w), index.pivots, m, 50, 5,
                                                 50, 5)
    plan_rows = refine_plan_checks("lm", q, LM_K, [
        ("adaptive", store, (qp.sel_part, qp.sel_lo, qp.sel_hi))])
    work = refine_work(store.rec_dfs, store.rec_gid, sp, lo, hi)
    bms, bby = refine_bound(work, LM_QUERIES, sp.shape[1], d, LM_K)
    rt = lambda: ops.refine_topk(store.data, store.norms, store.rec_dfs, store.rec_gid,
                                 q, sp, lo, hi, LM_K)
    kc["refine_topk"] = dict(plan_rows["adaptive"], **work, shape=(
        f"Q={LM_QUERIES} MP={sp.shape[1]} cap={store.capacity} n={d} k={LM_K}"),
        ms=cuda_ms(rt), device_ms=device_ms(rt, "refine", iters=5),
        plain_ms=cuda_ms(lambda: plain_refine_chunked(store, q, sp, lo, hi, LM_K),
                         iters=2, warmup=1),
        library_ms=None, bound_ms=bms, bound_by=bby)
    kc["pairwise_l2"] = pairwise_l2_row(q, datastore[:SCAN_CHUNK],
                                        "pairwise_l2 [lm Dss chunk]")
    for name, row in kc.items():
        say(f"{name} [lm]: " + json.dumps({a: (round(b, 5) if isinstance(b, float) else b)
                                           for a, b in row.items()}, default=float))
    out["peak_memory_gb"] = max(peaks + [torch.cuda.max_memory_allocated() / 1e9])
    del datastore, labels, index, store, x
    torch.cuda.empty_cache()
    return launches


def lm_recall_split(index, q, qp, datastore, i_ex, d_ex, w):
    """Where the kNN-LM's recall@16 goes.  The refine of a plan is exact
    (held against the plain refine), so what is lost is lost in the
    partitions a plan selects: recall at spend 4 (``adaptive_factor`` and K
    × 4) and with the exhaustive plan over the same index (every row), and,
    for the signature that routing reads, where the true neighbours rank
    among all rows by PAA-``w`` distance — the share of them that the
    nearest rows by PAA distance hold, as many rows as the adaptive (and
    the spend-4) plan's partitions hold, is what any filter on that
    signature could find at that spend."""
    import torch
    from repro_torch.core.query import (candidates_scanned, knn_query,
                                        register_recall_target)
    from repro_torch.eval import recall_at_k
    from repro_torch.kernels.l2 import pairwise_l2_plain
    from repro_torch.kernels.paa_kernel import paa_plain
    register_recall_target(4.0, name="lm_spend4")
    k = i_ex.shape[1]
    split, scanned = {}, {"adaptive": candidates_scanned(qp, index.store)}
    for label, variant in (("spend_4", "lm_spend4"), ("exhaustive", "exhaustive")):
        dist, gid, plan = knn_query(index, q, k, variant=variant)
        scanned[label] = candidates_scanned(plan, index.store)
        split[label] = {"recall_at_16": recall_at_k(gid, i_ex, k, approx_dist=dist,
                                                    exact_dist=d_ex),
                        "rows_scanned": float(scanned[label].float().mean())}
    d_paa = pairwise_l2_plain(paa_plain(q, w), paa_plain(datastore, w))   # [Q, rows]
    rank = torch.searchsorted(torch.sort(d_paa, dim=-1).values,
                              torch.gather(d_paa, 1, i_ex.long()))        # rows nearer
    split["paa"] = {
        "segments": w,
        "true_neighbours_in_paa_top_16": float((rank < k).float().mean()),
        "in_nearest_rows_of_adaptive_size": float(
            (rank < scanned["adaptive"][:, None]).float().mean()),
        "in_nearest_rows_of_spend_4_size": float(
            (rank < scanned["spend_4"][:, None]).float().mean()),
        "adaptive_rows_scanned": float(scanned["adaptive"].float().mean()),
        "median_rank_share_of_rows": float(rank.float().median()) / datastore.shape[0]}
    return split


TP_ARCH, TP_MOE_ARCH = "internlm2-1.8b", "olmoe-1b-7b"
TP_MESH = (1, 4)              # kv = 8 divides by 4: the cache splits by kv heads
TP_DECODE_MESH = (1, 16)      # the production model width: kv = 8 does not divide,
                              # the cache splits by sequence (set_decode_shard)
TP_MOE_MESH = (2, 2)
TP_TRAIN_MESH, TP_RESHARD_MESH = (2, 4), (2, 2)
TP_ROWS, TP_PROMPT, TP_TICKS, TP_MAX_LEN = 8, 256, 16, 512
# 255 splits into the prefill's 3 chunks; 272 = 17 · 16 slots holds both ticks
TP_FP32_PROMPT, TP_FP32_MAX_LEN, TP_FP32_TICKS = 255, 272, 2
TP_MOE_LAYERS, TP_MOE_ROWS, TP_MOE_SEQ = 4, 4, 64     # of olmoe's 16 layers
TP_TRAIN_SEQ, TP_TRAIN_BATCH, TP_TRAIN_STEPS = 1024, 8, 3
TP_FP32_TOL = 1e-3            # fp32 logits: within 1e-3·(1+|logit|)
TP_TRAIN_TOL = 5e-2           # the reference's sharded-step bound
TP_GRAD_ROWS = 2              # the fp32 first-moment step: one row per data shard
TP_GRAD_TOL = 1e-4            # fp32 first moment: |Δ| within 1e-4 of a leaf's largest
# (g): every family split after dense GQA and MoE, bf16 on TP_MESH; (h): the
# two whose split is new in kind (a sequence-split latent; SSD weights that
# do not follow their heads) in fp32; (i): the SSM's sharded train step
TP_FAMILIES = ("minicpm3-4b", "mamba2-780m", "zamba2-2.7b", "whisper-large-v3",
               "llama-3.2-vision-90b")
TP_FP32_ARCHS = ("minicpm3-4b", "mamba2-780m")
TP_SSM_ARCH = "mamba2-780m"
# depths of the (g) bf16 checks and the (i) step cut for conditioning, not
# memory: at full depth the seeded SSM families amplify rounding past the
# checks' bounds on ONE device (tools/tp_probe.py on an H100, PERF.md §6):
# its bf16 forward flips 92 (mamba2, 48 layers) and 243 (zamba2, 54) clear
# greedy tokens of its own fp32 forward (8 / 52 at 24 layers, 0 / 7 at 12),
# and its fp32 step in 2 microbatches differs from the unsplit step's first
# moment by 3.97e-4 of a leaf's largest entry at 48 layers, 1.27e-4 at 24,
# 5.15e-5 at 12, 4.22e-5 at 6; the mesh tracks that floor at every depth
TP_BF16_LAYERS = {"mamba2-780m": 12, "zamba2-2.7b": 6}
TP_SSM_STEP_LAYERS = 6
TP_FP32_FAMILY_PROMPT = 256   # one SSD chunk; 256 + 2 ticks fit the 272-slot cache


def profile_tick(fn):
    """(kernel launches, device busy ms) of one ``fn()`` under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(evs), sum(e.time_range.elapsed_us() for e in evs) / 1e3


def first_moment_check(args, one, tp, opt, tpipe, p_lay, o_lay, dev):
    """One fp32 step of ``TP_GRAD_ROWS`` rows on one device, then on
    ``tp``'s mesh from the same parameters.  After one step AdamW's first
    moment is (1 - b1)·clip·g, each leaf's reduced grad: every leaf must be
    within ``TP_GRAD_TOL`` of its largest entry, which a piece's grad
    zeroed, swapped or summed into the wrong slot fails.  Raises; returns
    the numbers."""
    import torch
    from repro_torch.models.params import named_params
    from repro_torch.train import make_train_step, shard_train_step
    batch = {k: v[:TP_GRAD_ROWS] for k, v in tpipe.batch_at(0).items()}
    init = lambda: one.init(torch.Generator(device=dev).manual_seed(args.seed + 4), dev,
                            dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    params = init()
    step = make_train_step(one, opt, kv_chunk=TRAIN_KV_CHUNK)
    (_, state, m1), one_s = sync_wall(lambda: step(params, opt.init(params), batch))
    ref_m, one_peak = state.m, torch.cuda.max_memory_allocated() / 1e9
    del params, state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pieces = p_lay.shard(init())
    step = shard_train_step(tp, opt, tp.mesh, kv_chunk=TRAIN_KV_CHUNK)
    (pieces, states, m2), mesh_s = sync_wall(lambda: step(pieces, opt.init_slots(pieces),
                                                          batch))
    del pieces
    got_m = o_lay.gather(states).m
    del states
    rel = {n: float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
           for (n, a), b in zip(named_params(ref_m).items(), named_params(got_m).values())}
    worst = max(rel, key=rel.get)
    row = {"mesh": list(tp.mesh.shape.values()), "rows": TP_GRAD_ROWS,
           "seq": batch["tokens"].shape[1] - 1, "dtype": "float32", "leaves": len(rel),
           "first_moment_rel_err": rel[worst], "worst_leaf": worst,
           "loss_rel_err": abs(float(m2["loss"]) - float(m1["loss"])) / abs(float(m1["loss"])),
           "grad_norm_rel_err": abs(float(m2["grad_norm"]) - float(m1["grad_norm"]))
           / float(m1["grad_norm"]), "one_device_step_s": one_s, "mesh_step_s": mesh_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "one_device_peak_memory_gb": one_peak}
    del ref_m, got_m
    torch.cuda.empty_cache()
    say(f"tp grads[fp32, one step of {TP_GRAD_ROWS} rows on {tuple(tp.mesh.shape.values())} "
        f"slots of one card vs one device]: " + json.dumps(row))
    if not rel[worst] <= TP_GRAD_TOL:
        raise SystemExit(f"tp: the first moment of {worst} differs from one device by "
                         f"{rel[worst]} of its largest entry (bound {TP_GRAD_TOL})")
    return row


def tp_serve(model, ps, batch, forced=None):
    """``prefill`` of ``batch`` into a ``TP_MAX_LEN`` cache and ``TP_TICKS``
    greedy ``decode_step`` ticks (the ``forced`` tokens where given):
    (last-position logits of each, the tokens fed, timings with one
    profiled tick's kernel launches and device ms)."""
    from repro_torch.models import decode_step, prefill
    (lg, cache), pre_s = sync_wall(lambda: prefill(
        model, ps, batch, max_len=TP_MAX_LEN, kv_chunk=PREFILL_CHUNK))
    logits, toks, ticks = [lg[:, -1]], [], []
    for i in range(TP_TICKS):
        tok = lg[:, -1:].argmax(-1).int() if forced is None else forced[i]
        toks.append(tok)
        (lg, cache), secs = sync_wall(lambda: decode_step(model, ps, cache, tok))
        logits.append(lg[:, -1])
        ticks.append(secs)
    launches, busy = profile_tick(lambda: decode_step(model, ps, cache, toks[-1]))
    steady = ticks[1:]
    rows = batch["tokens"].shape[0]
    return logits, toks, {"prefill_s": pre_s,
                          "tick_ms": sum(steady) / len(steady) * 1e3,
                          "tick_ms_first": ticks[0] * 1e3,
                          "tokens_per_s": rows * len(steady) / sum(steady),
                          "tick_kernel_launches": launches, "tick_device_ms": busy}


def tp_family(args, arch, dev, mesh, out):
    """(g): ``arch`` at full width in bf16 (the vlm at ``LM_DEPTH``, the SSM
    families at ``TP_BF16_LAYERS``), on
    ``mesh`` against one device: ``forward`` of ``TP_ROWS`` × ``TP_PROMPT``
    tokens by the lm rules, then ``prefill`` and ``TP_TICKS`` ticks, the
    mesh fed the one-device run's greedy tokens.  The one-device run goes
    first and its weights are freed before the mesh's pieces run.  Raises;
    returns the row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model
    cfg = get_config(arch, smoke=args.lm_smoke)
    depth = {**LM_DEPTH, **TP_BF16_LAYERS}.get(arch)
    if depth and not args.lm_smoke:
        cfg = cfg.replace(num_layers=depth)
        why = "memory" if arch in LM_DEPTH else "bf16 conditioning (TP_BF16_LAYERS)"
        out.setdefault("reduced", {})[arch] = \
            f"{depth} of {get_config(arch).num_layers} layers ({why})"
    torch.cuda.reset_peak_memory_stats()
    one = Model(cfg)
    params = one.init(torch.Generator(device=dev).manual_seed(args.seed + 5), dev)
    batch = TokenPipeline(cfg, global_batch=TP_ROWS, seq_len=TP_PROMPT, seed=args.seed,
                          device=dev).batch_at(0)
    batch["tokens"] = batch["tokens"][:, :TP_PROMPT]
    tp = Model(cfg, mesh=mesh)
    row = {"mesh": list(mesh.shape.values()), "layers": cfg.num_layers, "rows": TP_ROWS,
           "prompt": TP_PROMPT, "ticks": TP_TICKS, "max_len": TP_MAX_LEN}
    with torch.no_grad():
        full = one(params, batch, kv_chunk=PREFILL_CHUNK)
        ref_logits, toks, row["one_device"] = tp_serve(one, params, batch)
        pieces = tp.param_layout().shard(params)
        del params
        torch.cuda.empty_cache()
        row["forward"] = logits_rule(tp(pieces, batch, kv_chunk=PREFILL_CHUNK), full,
                                     f"tp [{arch} forward]")
        del full
        got_logits, _, row["mesh_run"] = tp_serve(tp, pieces, batch, forced=toks)
        row["decode"] = logits_rule(torch.stack(got_logits), torch.stack(ref_logits),
                                    f"tp [{arch} decode]")
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del pieces, ref_logits, got_logits, tp
    torch.cuda.empty_cache()
    say(f"tp family[{cfg.name}, {cfg.num_layers} layers, on {tuple(mesh.shape.values())} "
        f"slots of one card]: " + json.dumps(row, default=float))
    return row


def tp_fp32(args, arch, dev, mesh):
    """(h): ``arch`` at full width in fp32 on ``mesh`` against one device:
    ``forward`` of ``TP_ROWS`` × ``TP_FP32_FAMILY_PROMPT`` tokens, then its prefill
    into a ``TP_FP32_MAX_LEN`` cache and ``TP_FP32_TICKS`` ticks, every
    logit within ``TP_FP32_TOL``·(1+|logit|).  Raises; returns the row."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import Model, decode_step, prefill
    cfg = get_config(arch, smoke=args.lm_smoke)
    torch.cuda.reset_peak_memory_stats()
    one = Model(cfg)
    params = one.init(torch.Generator(device=dev).manual_seed(args.seed + 6), dev,
                      dtype=torch.float32)
    toks = TokenPipeline(cfg, global_batch=TP_ROWS, seq_len=TP_FP32_FAMILY_PROMPT + TP_FP32_TICKS,
                         seed=args.seed + 1, device=dev).batch_at(0)["tokens"]
    tp = Model(cfg, mesh=mesh)

    def run(model, ps):
        batch = {"tokens": toks[:, :TP_FP32_FAMILY_PROMPT]}
        logits = [model(ps, batch)]
        lg, cache = prefill(model, ps, batch, max_len=TP_FP32_MAX_LEN)
        logits.append(lg)
        for i in range(TP_FP32_TICKS):
            t = toks[:, TP_FP32_FAMILY_PROMPT + i:TP_FP32_FAMILY_PROMPT + i + 1]
            lg, cache = decode_step(model, ps, cache, t)
            logits.append(lg)
        return logits

    with torch.no_grad():
        ref = run(one, params)
        pieces = tp.param_layout().shard(params)
        del params
        got = run(tp, pieces)
        names = ["forward", "prefill"] + [f"tick {i}" for i in range(TP_FP32_TICKS)]
        errs = [logits_rule(g, r, f"tp [{arch} fp32 {n}]", TP_FP32_TOL)["rel_err"]
                for n, g, r in zip(names, got, ref)]
    row = {"mesh": list(mesh.shape.values()), "layers": cfg.num_layers, "rows": TP_ROWS,
           "prompt": TP_FP32_FAMILY_PROMPT, "max_len": TP_FP32_MAX_LEN, "ticks": TP_FP32_TICKS,
           "dtype": "float32", "rel_err": dict(zip(names, errs)),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.use_mla:
        row["latent_split"] = "sequence" if TP_FP32_MAX_LEN % mesh.shape["model"] == 0 \
            else "whole"
    del pieces, ref, got, tp
    torch.cuda.empty_cache()
    say(f"tp fp32[{cfg.name} on {tuple(mesh.shape.values())} slots of one card]: "
        + json.dumps(row, default=float))
    return row


def tp_path(args, dev, report):
    """The model axis (module docstring, item 8): (a) internlm2-1.8b on
    ``TP_MESH`` — forward, prefill and ``TP_TICKS`` decode ticks against one
    device; (b) on ``TP_DECODE_MESH``, fp32 decode through
    ``set_decode_shard``; (c) olmoe-1b-7b on ``TP_MOE_MESH`` against each
    data half alone; (d) the train step on ``TP_TRAIN_MESH`` against the
    one-device step; (e) a params checkpoint saved from it restored onto
    ``TP_RESHARD_MESH``; (f) the production mesh's layout round trip;
    (g) each of ``TP_FAMILIES`` on ``TP_MESH`` in bf16 (:func:`tp_family`);
    (h) ``TP_FP32_ARCHS`` in fp32 (:func:`tp_fp32`); (i) ``TP_SSM_ARCH``'s
    fp32 first moment on ``TP_TRAIN_MESH``.  Every mesh is slots of this
    one card.  Every hard check raises.
    Returns the path's launch counts (it runs none of the CLIMBER
    kernels)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh, make_production_mesh
    from repro_torch.models import Model, decode_step, prefill
    from repro_torch.models import layers as L
    from repro_torch.models.params import named_params, tree_map
    from repro_torch.train import (AdamW, constant_lr, make_state_shardings, make_train_step,
                                   restore_checkpoint, save_checkpoint, shard_train_step)

    smoke = args.lm_smoke
    mesh_of = lambda shape: make_mesh(shape, ("data", "model"), [dev] * (shape[0] * shape[1]))
    decode_mesh = (1, 4) if smoke else TP_DECODE_MESH     # smoke widths have 4 heads
    out = report.setdefault("tp", {"arch": TP_ARCH, "smoke_widths": smoke,
                                   "note": "every mesh is slots of one card: no number "
                                           "here says what several cards gain"})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_path = time.perf_counter()
    peaks = []

    # ---- (a) internlm2 on TP_MESH: forward, prefill, decode ticks -------
    cfg = get_config(TP_ARCH, smoke=smoke)
    one = Model(cfg)
    params = one.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    mesh = mesh_of(TP_MESH)
    tp = Model(cfg, mesh=mesh)
    pieces = tp.param_layout().shard(params)
    pipe = TokenPipeline(cfg, global_batch=TP_ROWS, seq_len=TP_PROMPT, seed=args.seed,
                         device=dev)
    prompt = pipe.batch_at(0)["tokens"][:, :TP_PROMPT]
    row = {"mesh": list(TP_MESH), "rows": TP_ROWS, "prompt": TP_PROMPT,
           "ticks": TP_TICKS, "max_len": TP_MAX_LEN}
    with torch.no_grad():
        full = one(params, {"tokens": prompt}, kv_chunk=PREFILL_CHUNK)
        row["forward"] = logits_rule(tp(pieces, {"tokens": prompt}, kv_chunk=PREFILL_CHUNK),
                                     full, "tp [forward]")
        del full

        ref_logits, toks, row["one_device"] = tp_serve(one, params, {"tokens": prompt})
        got_logits, _, row["mesh_run"] = tp_serve(tp, pieces, {"tokens": prompt}, forced=toks)
        row["decode"] = logits_rule(torch.stack(got_logits), torch.stack(ref_logits),
                                    "tp [decode]")
    out["serve"] = row
    peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    split = "kv heads" if cfg.num_kv_heads % TP_MESH[1] == 0 else "sequence"
    row["cache_split"] = split
    say(f"tp serve[{cfg.name} on {TP_MESH} slots of one card, cache split by {split}]: "
        + json.dumps(row, default=float))
    del pieces, ref_logits, got_logits, params, tp
    torch.cuda.empty_cache()

    # ---- (b) fp32 decode on the production model width, set_decode_shard --
    torch.cuda.reset_peak_memory_stats()
    params = one.init(torch.Generator(device=dev).manual_seed(args.seed + 1), dev,
                      dtype=torch.float32)
    mesh = mesh_of(decode_mesh)
    tp = Model(cfg, mesh=mesh)
    pieces = tp.param_layout().shard(params)
    toks = pipe.batch_at(1)["tokens"][:, :TP_FP32_PROMPT + TP_FP32_TICKS]
    # every tick writes a slot of its own: none clamps onto the last
    assert TP_FP32_PROMPT + TP_FP32_TICKS <= TP_FP32_MAX_LEN
    assert TP_FP32_MAX_LEN % decode_mesh[1] == 0          # set_decode_shard's split
    row = {"mesh": list(decode_mesh), "rows": TP_ROWS, "prompt": TP_FP32_PROMPT,
           "max_len": TP_FP32_MAX_LEN, "ticks": TP_FP32_TICKS, "dtype": "float32",
           "cache_split": "sequence" if cfg.num_kv_heads % decode_mesh[1] else "kv heads"}
    with torch.no_grad():
        def run(model, ps):
            lg, cache = prefill(model, ps, {"tokens": toks[:, :TP_FP32_PROMPT]},
                                max_len=TP_FP32_MAX_LEN)
            logits, secs = [lg], []
            for i in range(TP_FP32_TICKS):
                t = toks[:, TP_FP32_PROMPT + i:TP_FP32_PROMPT + i + 1]
                (lg, cache), s_ = sync_wall(lambda: decode_step(model, ps, cache, t))
                logits.append(lg)
                secs.append(s_)
            return logits, secs

        ref, ref_s = run(one, params)
        L.set_decode_shard(mesh)
        try:
            got, got_s = run(tp, pieces)
        finally:
            L.set_decode_shard(None)
        row["rel_err"] = [logits_rule(g, r, f"tp [fp32 decode {i}]", TP_FP32_TOL)["rel_err"]
                          for i, (g, r) in enumerate(zip(got, ref))]
        row["one_device_tick_ms"] = [x * 1e3 for x in ref_s]
        row["mesh_tick_ms"] = [x * 1e3 for x in got_s]
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    peaks.append(row["peak_memory_gb"])
    out["fp32_decode"] = row
    say(f"tp fp32 decode[{cfg.name} on {decode_mesh} slots of one card, "
        f"set_decode_shard]: " + json.dumps(row, default=float))
    del params, pieces, tp, ref, got
    torch.cuda.empty_cache()

    # ---- (c) olmoe on TP_MOE_MESH against each data half alone -----------
    torch.cuda.reset_peak_memory_stats()
    mcfg = get_config(TP_MOE_ARCH, smoke=smoke)
    if not smoke:
        mcfg = mcfg.replace(num_layers=TP_MOE_LAYERS)
    mone = Model(mcfg)
    params = mone.init(torch.Generator(device=dev).manual_seed(args.seed + 2), dev,
                       dtype=torch.float32)
    mtoks = TokenPipeline(mcfg, global_batch=TP_MOE_ROWS, seq_len=TP_MOE_SEQ,
                          seed=args.seed, device=dev).batch_at(0)["tokens"][:, :TP_MOE_SEQ]
    half = TP_MOE_ROWS // TP_MOE_MESH[0]
    with torch.no_grad():
        halves = torch.cat([mone(params, {"tokens": mtoks[i:i + half]})
                            for i in range(0, TP_MOE_ROWS, half)])
        whole = mone(params, {"tokens": mtoks})
        mtp = Model(mcfg, mesh=mesh_of(TP_MOE_MESH))
        got = mtp(mtp.param_layout().shard(params), {"tokens": mtoks})
    row = {"mesh": list(TP_MOE_MESH), "layers": mcfg.num_layers, "rows": TP_MOE_ROWS,
           "seq": TP_MOE_SEQ, "dtype": "float32",
           "rel_err_vs_halves": logits_rule(got, halves, "tp [olmoe vs each data half]",
                                            TP_FP32_TOL)["rel_err"],
           "rel_err_vs_whole_batch": float(((got - whole).abs() / (1 + whole.abs())).max()),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if not smoke:
        out.setdefault("reduced", {})[TP_MOE_ARCH] = \
            f"{TP_MOE_LAYERS} of {get_config(TP_MOE_ARCH).num_layers} layers"
    peaks.append(row["peak_memory_gb"])
    out["moe"] = row
    say(f"tp moe[{mcfg.name} on {TP_MOE_MESH} slots of one card]: " + json.dumps(row))
    del params, halves, whole, got, mtp
    torch.cuda.empty_cache()

    # ---- (d) the train step on TP_TRAIN_MESH against one device ----------
    torch.cuda.reset_peak_memory_stats()
    seq = 64 if smoke else TP_TRAIN_SEQ
    opt = AdamW(lr=constant_lr(TRAIN_LR))
    tpipe = TokenPipeline(cfg, TP_TRAIN_BATCH, seq, seed=args.seed, mode="periodic",
                          device=dev)
    mesh = mesh_of(TP_TRAIN_MESH)
    tp = Model(cfg, mesh=mesh)
    p_lay, o_lay = make_state_shardings(mesh, tp)
    out["grads"] = grads = first_moment_check(args, one, tp, opt, tpipe, p_lay, o_lay, dev)
    peaks += [grads["one_device_peak_memory_gb"], grads["peak_memory_gb"]]
    torch.cuda.reset_peak_memory_stats()
    params = one.init(torch.Generator(device=dev).manual_seed(args.seed + 3), dev)
    host = tree_map(lambda t: t.to("cpu", copy=True), params)
    step = make_train_step(one, opt, kv_chunk=TRAIN_KV_CHUNK)
    state, ref_loss, ref_s = opt.init(params), [], []
    for i in range(TP_TRAIN_STEPS):
        (params, state, met), secs = sync_wall(lambda: step(params, state, tpipe.batch_at(i)))
        ref_loss.append(float(met["loss"]))
        ref_s.append(secs)
    ref_out = params["embed"]["out"].to("cpu", copy=True)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del params, state, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pieces = p_lay.shard(tree_map(lambda t: t.to(dev), host))
    del host
    state = opt.init_slots(pieces)
    sstep = shard_train_step(tp, opt, mesh, kv_chunk=TRAIN_KV_CHUNK)
    losses, secs_l = [], []
    for i in range(TP_TRAIN_STEPS):
        (pieces, state, met), secs = sync_wall(lambda: sstep(pieces, state,
                                                             tpipe.batch_at(i)))
        losses.append(float(met["loss"]))
        secs_l.append(secs)
    mesh_peak = torch.cuda.max_memory_allocated() / 1e9
    trained = p_lay.gather(pieces)
    w_delta = float((trained["embed"]["out"].float().cpu() - ref_out.float()).abs().max())
    loss_delta = max(abs(a - b) for a, b in zip(losses, ref_loss))
    tokens = TP_TRAIN_BATCH * seq
    row = {"mesh": list(TP_TRAIN_MESH), "seq": seq, "batch": TP_TRAIN_BATCH,
           "steps": TP_TRAIN_STEPS, "losses": losses, "one_device_losses": ref_loss,
           "loss_delta": loss_delta, "embed_out_delta": w_delta,
           "step_s": sum(secs_l[1:]) / len(secs_l[1:]), "first_step_s": secs_l[0],
           "one_device_step_s": sum(ref_s[1:]) / len(ref_s[1:]),
           "tokens_per_s": tokens * len(secs_l[1:]) / sum(secs_l[1:]),
           "one_device_tokens_per_s": tokens * len(ref_s[1:]) / sum(ref_s[1:]),
           "peak_memory_gb": mesh_peak, "one_device_peak_memory_gb": one_peak}
    say(f"tp train[{cfg.name} on {TP_TRAIN_MESH} slots of one card, seq {seq}, batch "
        f"{TP_TRAIN_BATCH}]: " + json.dumps(row, default=float))
    if not (loss_delta < TP_TRAIN_TOL and w_delta < TP_TRAIN_TOL):
        raise SystemExit(f"tp: the {TP_TRAIN_MESH} train step differs from one device: "
                         f"loss {loss_delta}, embed/out {w_delta}")
    del state, sstep, ref_out
    torch.cuda.empty_cache()
    peaks += [one_peak, mesh_peak]

    # ---- (e) a params checkpoint from TP_TRAIN_MESH onto TP_RESHARD_MESH --
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="smoke_tp_", dir=ROOT / "build"))
    try:
        _, save_s = sync_wall(lambda: save_checkpoint(ckpt, TP_TRAIN_STEPS, pieces,
                                                      layout=p_lay))
        ckpt_gb = sum(f.stat().st_size for f in (ckpt / f"step_{TP_TRAIN_STEPS:08d}").iterdir()) / 1e9
        small = Model(cfg, mesh=mesh_of(TP_RESHARD_MESH))
        (slots, at, _), restore_s = sync_wall(lambda: restore_checkpoint(
            ckpt, small.abstract(), device=small.param_layout()))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    back = small.param_layout().gather(slots)
    same = at == TP_TRAIN_STEPS and all(
        torch.equal(byte_view(a), byte_view(b))
        for a, b in zip(named_params(trained).values(), named_params(back).values()))
    row["checkpoint"] = {"gb": ckpt_gb, "save_s": save_s, "restore_s": restore_s,
                         "from": list(TP_TRAIN_MESH), "onto": list(TP_RESHARD_MESH),
                         "byte_equal": same}
    say(f"tp checkpoint: {ckpt_gb:.2f} GB of params saved from {TP_TRAIN_MESH} in "
        f"{save_s:.2f} s, restored onto {TP_RESHARD_MESH} in {restore_s:.2f} s, "
        f"byte-equal: {same}")
    if not same:
        raise SystemExit("tp: the re-placed checkpoint differs from the params saved")
    del slots, back, pieces
    torch.cuda.empty_cache()

    # ---- (f) the production mesh's layout round trip ---------------------
    prod = make_production_mesh(devices=[dev] * 256)
    pm = Model(cfg, mesh=prod)
    (prod_slots, shard_s) = sync_wall(lambda: pm.param_layout().shard(trained))
    back, gather_s = sync_wall(lambda: pm.param_layout().gather(prod_slots))
    same = all(torch.equal(byte_view(a), byte_view(b))
               for a, b in zip(named_params(trained).values(), named_params(back).values()))
    row["production_mesh"] = {"shape": prod.shape, "shard_s": shard_s, "gather_s": gather_s,
                              "byte_equal": same}
    say(f"tp production mesh {prod.shape} ({prod.size} slots of one card): params "
        f"laid out in {shard_s:.2f} s, gathered in {gather_s:.2f} s, byte-equal: {same}")
    if not same:
        raise SystemExit("tp: the production mesh's layout does not round-trip the params")
    out["train"] = row
    del trained, back, prod_slots, tp, one
    torch.cuda.empty_cache()

    # ---- (g) MLA, SSM, hybrid, encdec and vlm on TP_MESH, bf16 -------------
    mesh = mesh_of(TP_MESH)
    out["families"] = {arch: tp_family(args, arch, dev, mesh, out) for arch in TP_FAMILIES}
    peaks += [r["peak_memory_gb"] for r in out["families"].values()]

    # ---- (h) the two splits new in kind, fp32, on TP_MESH ------------------
    out["fp32_families"] = {arch: tp_fp32(args, arch, dev, mesh) for arch in TP_FP32_ARCHS}
    peaks += [r["peak_memory_gb"] for r in out["fp32_families"].values()]

    # ---- (i) the SSM's train step on TP_TRAIN_MESH, fp32 first moment ------
    torch.cuda.reset_peak_memory_stats()
    scfg = get_config(TP_SSM_ARCH, smoke=smoke)
    if not smoke:
        scfg = scfg.replace(num_layers=TP_SSM_STEP_LAYERS)
        out.setdefault("reduced", {})[f"{TP_SSM_ARCH} step"] = \
            f"{TP_SSM_STEP_LAYERS} of {get_config(TP_SSM_ARCH).num_layers} layers " \
            f"(fp32 conditioning: TP_BF16_LAYERS' note)"
    smesh = mesh_of(TP_TRAIN_MESH)
    stp = Model(scfg, mesh=smesh)
    p_lay, o_lay = make_state_shardings(smesh, stp)
    spipe = TokenPipeline(scfg, TP_TRAIN_BATCH, seq, seed=args.seed, mode="periodic",
                          device=dev)
    out["ssm_grads"] = first_moment_check(args, Model(scfg), stp, opt, spipe, p_lay, o_lay,
                                          dev)
    peaks += [out["ssm_grads"]["one_device_peak_memory_gb"],
              out["ssm_grads"]["peak_memory_gb"]]
    del stp
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out["seconds"] = time.perf_counter() - t_path
    out["peak_memory_gb"] = max(peaks + [torch.cuda.max_memory_allocated() / 1e9])
    say(f"tp-path launches: {launches} ({out['seconds']:.1f} s, peak device memory "
        f"{out['peak_memory_gb']:.1f} GB)")
    return launches


TRAIN_ARCH = "internlm2-1.8b"
# train_4k's sequence (utils/config SHAPES); its global batch of 256 cut to
# 8 sequences in 4 microbatches of 2, and the run to 12 steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = 4096, 8, 4, 12
# a checkpoint at this width is 18.9 GB (bf16 weights, fp32 moments), and the
# smoke keeps what it writes to disk under 45 GiB: a checkpoint at step 8 and
# the final one at 12 (every 4 would write four)
TRAIN_EVERY = 8
TRAIN_LR, TRAIN_KV_CHUNK = 3e-4, 2048
TRAIN_CHECK_LAYERS = 4                 # microbatched ≡ plain, 2 slots ≡ 1
TRAIN_FAMILIES = ("mamba2-780m", "olmoe-1b-7b")   # autograd through SSD, MoE
TRAIN_FAMILY_LAYERS, TRAIN_FAMILY_BATCH = 2, 2
# train_loss against cross_entropy(forward) of the same parameters: equal,
# except through moe_local, whose index_add_ accumulates with atomics on the
# card in an order that varies between runs
MOE_LOSS_RTOL = 1e-5


def byte_view(t):
    """A tensor's bytes, for byte-for-byte comparison."""
    import torch
    return t.detach().reshape(-1).view(torch.uint8)


def expected_manifest(infos):
    """The reference's flattened (key, shape, dtype) of ``{"params",
    "opt"}``, from ``Model.infos()``' stacked tree and ``AdamWState``."""
    import torch

    def walk(tree, key, dtype=None):
        if isinstance(tree, dict):
            return [e for k in sorted(tree) for e in walk(tree[k], f"{key}/{k}", dtype)]
        dt = dtype or tree.dtype
        return [(key, list(tree.shape),
                 "bfloat16" if dt == torch.bfloat16 else str(dt).split(".")[-1])]
    return ([("opt/.step", [], "int32")] + walk(infos, "opt/.m", torch.float32)
            + walk(infos, "opt/.v", torch.float32) + walk(infos, "params"))


def train_path(args, dev, report):
    """The training plane (module docstring, item 8): ``train()`` at
    ``TRAIN_ARCH``'s full width with an injected failure and its recovery,
    the checkpoint's format, then microbatched ≡ plain and 2 slots ≡ 1 at
    ``TRAIN_CHECK_LAYERS`` layers, and one step of each of
    ``TRAIN_FAMILIES``.  Every hard check raises.  Returns the path's
    launch counts (the path runs none of the CLIMBER kernels)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDraws, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import Model, count_params, cross_entropy, named_params
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import (AdamW, StepFailure, constant_lr, make_state_shardings,
                                   make_train_step, shard_train_step, value_and_grad)

    smoke = args.lm_smoke
    seq, steps, every = (64, 6, 4) if smoke else (TRAIN_SEQ, TRAIN_STEPS, TRAIN_EVERY)
    fail_at = every + 1                         # restores from step `every`
    out = report.setdefault("train", {
        "arch": TRAIN_ARCH, "smoke_widths": smoke, "seq": seq, "batch": TRAIN_BATCH,
        "microbatches": TRAIN_MICRO, "steps": steps, "checkpoint_every": every,
        "lr": TRAIN_LR, "kv_chunk": TRAIN_KV_CHUNK, "fail_at": fail_at})
    out["reduced"] = {"batch": f"{TRAIN_BATCH} of train_4k's 256 sequences",
                      "steps": f"{steps}",
                      "checkpoints": f"at steps {every} and {steps} (TRAIN_EVERY)"}
    cfg = get_config(TRAIN_ARCH, smoke=smoke)
    out["params"] = count_params(Model(cfg).infos())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_path = time.perf_counter()

    # ---- (a) train() at full width, failing once at fail_at ---------------
    class FailOnce(TokenDraws):
        """The pipeline's draws, raising StepFailure the first time step
        ``fail_at``'s batch is drawn: that step fails before it computes."""
        failed = False

        def phase(self, seed, step, lo, n, vocab):
            if step == fail_at and not self.failed:
                self.failed = True
                raise StepFailure(f"injected at step {step}")
            return super().phase(seed, step, lo, n, vocab)

    events, audit = [], {}

    def on_event(kind, info):
        now = time.perf_counter()
        if kind == "checkpoint" and info["step"] == fail_at - 1:
            audit["saved"] = [x.detach().to("cpu", copy=True)
                              for x in tree_leaves(info["state"])]
        if kind == "restored":
            saved = audit.pop("saved")
            got = list(tree_leaves(info["state"]))
            audit["restored_leaves"] = len(got)
            audit["restored_bytes"] = sum(x.numel() * x.element_size() for x in got)
            audit["restored_equal"] = len(got) == len(saved) and all(
                a.dtype == b.dtype and a.shape == b.shape and
                torch.equal(byte_view(a.cpu()), byte_view(b)) for a, b in zip(got, saved))
            del saved
        events.append((kind, dict({k: v for k, v in info.items() if k != "state"},
                                  t=now)))

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = Path(tempfile.mkdtemp(prefix="smoke_train_", dir=ROOT / "build"))
    try:
        (params, losses), wall = sync_wall(lambda: train(
            TRAIN_ARCH, smoke=smoke, steps=steps, batch=TRAIN_BATCH, seq=seq,
            ckpt_dir=str(ckpt), checkpoint_every=every, lr=TRAIN_LR,
            kv_chunk=TRAIN_KV_CHUNK, microbatches=TRAIN_MICRO, log_every=1,
            seed=args.seed, data_mode="periodic", device=dev, draws=FailOnce(),
            on_event=on_event))
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the checkpoint is the reference's format
        final = ckpt / f"step_{steps:08d}"
        man = json.loads((final / "MANIFEST.json").read_text())
        got_keys = [(e["key"], e["shape"], e["dtype"]) for e in man["keys"]]
        want_keys = expected_manifest(Model(cfg).infos())
        if got_keys != want_keys:
            raise SystemExit(f"train: the checkpoint's keys differ from the reference's "
                             f"({len(got_keys)} vs {len(want_keys)})")
        import zipfile
        with zipfile.ZipFile(final / "shard_p0.npz") as zf:
            descr = {e["dtype"]: zf.open(e["name"] + ".npy").read(128)
                     for e in man["keys"]}
        if b"'descr': '<V2'" not in descr["bfloat16"]:
            raise SystemExit("train: a bf16 leaf is not stored as '<V2'")
        ckpt_gb = sum(f.stat().st_size for f in final.iterdir()) / 1e9
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    step_ev = [i for k, i in events if k == "step"]
    kinds = [(k, i["step"]) for k, i in events if k != "step"]
    want = ([("checkpoint", every), ("failure", fail_at), ("restored", every)]
            + [("checkpoint", s) for s in range(2 * every, steps + 1, every)])
    if [e for e in kinds if e[0] != "straggler"] != want:
        raise SystemExit(f"train: recovery events {kinds}, expected {want}")
    first, again = [i["loss"] for i in step_ev if i["step"] == fail_at - 1]
    if first != again:
        raise SystemExit(f"train: step {fail_at - 1}'s loss after the restore {again!r} "
                         f"differs from its first {first!r}")
    if not audit.get("restored_equal"):
        raise SystemExit("train: the restored parameters and moments differ from the "
                         "tensors that were saved")
    if not all(math.isfinite(i["loss"]) and math.isfinite(i["grad_norm"]) for i in step_ev):
        raise SystemExit("train: a non-finite loss or grad norm")
    head, tail = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
    if not tail < head:
        raise SystemExit(f"train: the loss did not fall ({head:.4f} -> {tail:.4f})")
    secs = [i["data_s"] + i["step_s"] for i in step_ev]
    tokens = TRAIN_BATCH * seq
    # a checkpoint's seconds: from its step's event to its own; the
    # restore's: from the failure's
    after = lambda j: events[j][1]["t"] - events[j - 1][1]["t"]
    save_s = [after(j) for j, (k, _) in enumerate(events) if k == "checkpoint"]
    restore_s = [after(j) for j, (k, _) in enumerate(events) if k == "restored"]
    out["run"] = {
        "wall_s": wall, "steps_run": len(step_ev), "losses": losses,
        "grad_norms": [i["grad_norm"] for i in step_ev],
        "first_step_s": secs[0], "step_s": sum(secs[1:]) / len(secs[1:]),
        "tokens_per_s": tokens * len(secs[1:]) / sum(secs[1:]),
        "data_s": sum(i["data_s"] for i in step_ev[1:]) / len(secs[1:]),
        "peak_memory_gb": peak, "checkpoint_gb": ckpt_gb, "save_s": save_s,
        "restore_s": restore_s,
        "loss_head_mean": head, "loss_tail_mean": tail,
        "replayed_step": fail_at - 1, "replayed_loss": again,
        "restored_leaves": audit["restored_leaves"],
        "restored_gb": audit["restored_bytes"] / 1e9, "events": kinds}
    say(f"train[{cfg.name}, seq {seq}, batch {TRAIN_BATCH} = {TRAIN_MICRO} x "
        f"{TRAIN_BATCH // TRAIN_MICRO}]: " + json.dumps(
            {a: (round(b, 4) if isinstance(b, float) else
                 [round(x, 4) for x in b] if a in ("losses", "grad_norms", "save_s",
                                                   "restore_s") else b)
             for a, b in out["run"].items()}))
    say(f"train: StepFailure at step {fail_at}, restored from step {fail_at - 1}: "
        f"{audit['restored_leaves']} leaves byte-equal to those saved, step "
        f"{fail_at - 1}'s loss bit-equal ({again!r}); the checkpoint's {len(got_keys)} "
        f"keys and shapes are the reference's, bf16 as '<V2'")

    # the split of one more step: data, forward + backward, optimizer
    model = Model(cfg)
    opt = AdamW(lr=constant_lr(TRAIN_LR))
    pipe = TokenPipeline(cfg, TRAIN_BATCH, seq, seed=args.seed, mode="periodic",
                         device=dev)
    state = opt.init(params)
    batch, data_s = sync_wall(lambda: pipe.batch_at(steps))
    (loss, grads), fb_s = sync_wall(lambda: value_and_grad(
        model, params, batch, kv_chunk=TRAIN_KV_CHUNK, microbatches=TRAIN_MICRO))
    _, opt_s = sync_wall(lambda: opt.update(grads, state, params))
    del params, state, grads, batch
    torch.cuda.empty_cache()
    # the plain attention's part of it: one layer's flash_attention at the
    # step's shapes, forward twice (remat recomputes it) and backward once,
    # times layers × microbatches
    from repro_torch.models.layers import flash_attention
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shape = lambda h: (TRAIN_BATCH // TRAIN_MICRO, seq, h, cfg.head_dim)
    q, k, v = (torch.randn(shape(h), generator=g, device=dev).bfloat16().requires_grad_()
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))

    def attention():
        with torch.no_grad():
            flash_attention(q, k, v, causal=True, kv_chunk=TRAIN_KV_CHUNK)
        o = flash_attention(q, k, v, causal=True, kv_chunk=TRAIN_KV_CHUNK)
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))

    attention()
    _, attn_s = sync_wall(attention)
    attn_s *= cfg.num_layers * TRAIN_MICRO
    out["split"] = {"data_s": data_s, "forward_backward_s": fb_s, "optimizer_s": opt_s,
                    "attention_s": attn_s,
                    "attention_share": attn_s / (data_s + fb_s + opt_s)}
    say("train split of one step: " + json.dumps(
        {a: round(b, 4) for a, b in out["split"].items()}))
    del q, k, v
    torch.cuda.empty_cache()

    # ---- (b) microbatched ≡ plain, 2 slots ≡ 1, at TRAIN_CHECK_LAYERS ----
    ccfg = cfg.replace(num_layers=TRAIN_CHECK_LAYERS)
    model = Model(ccfg)
    init = model.init(torch.Generator(device=dev).manual_seed(args.seed + 1), dev)
    batch = TokenPipeline(ccfg, TRAIN_BATCH, seq, seed=args.seed, mode="periodic",
                          device=dev).batch_at(0)
    runs = {}
    # two slots take each microbatch's rows between them, so at TRAIN_MICRO
    # microbatches they hold the rows one device holds at a time
    for name, micro, slots in (("micro", TRAIN_MICRO, 1), ("plain", 1, 1),
                               ("two_slots", TRAIN_MICRO, 2)):
        p = tree_map(torch.clone, init)
        torch.cuda.reset_peak_memory_stats()
        if slots == 1:
            fn = make_train_step(model, opt, kv_chunk=TRAIN_KV_CHUNK, microbatches=micro)
            state = opt.init(p)
        else:
            mesh = make_mesh(slots, [dev] * slots)
            fn = shard_train_step(model, opt, mesh, kv_chunk=TRAIN_KV_CHUNK,
                                  microbatches=micro)
            p_lay, _ = make_state_shardings(mesh, model)
            p = p_lay.shard(p)
            state = opt.init_slots(p)
        (p, _, met), secs = sync_wall(lambda: fn(p, state, batch))
        del state
        runs[name] = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"]),
                      "seconds": secs, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "params": named_params(p_lay.gather(p) if slots > 1 else p)}
    a, b = runs["micro"], runs["two_slots"]
    w_delta = max(float((a["params"][n].float() - b["params"][n].float()).abs().max())
                  for n in a["params"])
    checks = {"micro_vs_plain_loss_delta": abs(a["loss"] - runs["plain"]["loss"]),
              "two_slots_vs_one_loss_rel": abs(b["loss"] - a["loss"]) / a["loss"],
              "two_slots_vs_one_w_delta": w_delta}
    for r in runs.values():
        del r["params"]
    runs_peaks = list(runs.values())
    out["checks"] = dict(checks, layers=TRAIN_CHECK_LAYERS, runs=runs)
    say(f"train checks [{TRAIN_CHECK_LAYERS} layers]: " + json.dumps(out["checks"],
                                                                       default=float))
    if not checks["micro_vs_plain_loss_delta"] < 5e-2:
        raise SystemExit(f"train: microbatched loss differs from plain by "
                         f"{checks['micro_vs_plain_loss_delta']}")
    if not (checks["two_slots_vs_one_loss_rel"] <= 1e-5 and w_delta < 5e-2):
        raise SystemExit(f"train: 2 slots differ from one: {checks}")
    del init, batch, runs, a, b, p
    torch.cuda.empty_cache()

    # ---- (c) autograd through the SSD scan and moe_local ------------------
    out["families"] = {}
    for arch in TRAIN_FAMILIES:
        fcfg = get_config(arch, smoke=smoke).replace(num_layers=TRAIN_FAMILY_LAYERS)
        fmodel = Model(fcfg)
        fparams = fmodel.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
        fbatch = TokenPipeline(fcfg, TRAIN_FAMILY_BATCH, seq, seed=args.seed,
                               mode="periodic", device=dev).batch_at(0)
        torch.cuda.reset_peak_memory_stats()
        (loss, grads), secs = sync_wall(lambda: value_and_grad(
            fmodel, fparams, fbatch, kv_chunk=TRAIN_KV_CHUNK))
        finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                   for g in grads)
        with torch.no_grad():
            ref = cross_entropy(fmodel(fparams, {"tokens": fbatch["tokens"][:, :-1]},
                                       kv_chunk=TRAIN_KV_CHUNK), fbatch["tokens"][:, 1:])
        _, _, stats = opt.update(grads, opt.init(fparams), fparams)
        row = {"layers": fcfg.num_layers, "loss": float(loss), "forward_ce": float(ref),
               "grad_norm": float(stats["grad_norm"]), "seconds": secs,
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        out["families"][arch] = row
        say(f"train family[{arch}]: " + json.dumps(row))
        if not (finite and math.isfinite(row["grad_norm"])):
            raise SystemExit(f"train: {arch}'s loss or grads are not finite")
        rtol = MOE_LOSS_RTOL if fcfg.family == "moe" else 0.0
        if abs(row["loss"] - row["forward_ce"]) > rtol * abs(row["forward_ce"]):
            raise SystemExit(f"train: {arch}'s train_loss {row['loss']!r} differs from "
                             f"cross_entropy(forward) {row['forward_ce']!r}")
        del fparams, grads, fbatch
        torch.cuda.empty_cache()

    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out["seconds"] = time.perf_counter() - t_path
    out["peak_memory_gb"] = max([peak] + [r["peak_memory_gb"] for r in runs_peaks]
                                + [r["peak_memory_gb"] for r in out["families"].values()])
    say(f"train-path launches: {launches} ({out['seconds']:.1f} s, peak device memory "
        f"{out['peak_memory_gb']:.1f} GB)")
    return launches


DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_CELLS = ("train_4k", "decode_32k")       # (a), counted on the (16, 16) meta slots
DRYRUN_KERNELS = ("paa", "pivot_rank", "refine_topk")
DRYRUN_TICK = (8, 4096)                          # (b): rows, cache tokens, one device
ALLOC_ROUND = 512                                # the caching allocator's rounding
ALLOC_SLACK = 1 << 20                            # its largest unsplit tail of a block
DRYRUN_SLOTS = 256                               # (c): one slot of (16, 16)


def requested_bytes(dev) -> int:
    """The caching allocator's live requested bytes (unrounded)."""
    import torch
    return torch.cuda.memory_stats(dev)["requested_bytes.all.current"]


def counted_bound_ms(r) -> float:
    """The larger of a dry-run result's compute, memory and collective
    terms, in ms: the least time its counted per-device work could take."""
    return max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3


def dryrun_path(args, dev, report):
    """The dry-run tools (module docstring, item 10): (a) counts on (16, 16)
    ``meta`` slots, (b) one counted decode tick run whole on the card with
    its argument bytes held to the allocator, (c) one slot's share of the
    CLIMBER build and query steps through the kernels, timed against its
    counted bound and held against the plain versions.  Every hard check
    raises.  Returns the path's launch counts, read after (c)'s timed runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import make_dataset, make_queries
    from repro_torch.kernels import ops
    from repro_torch.kernels.refine_topk import refine_topk_plain, refine_topk_work, refine_work
    from repro_torch.launch import climber_dryrun as CD
    from repro_torch.launch import dryrun as DR
    from repro_torch.models import Model, count_params, decode_step, init_cache
    from repro_torch.utils import roofline as RL
    from repro_torch.utils.config import ShapeConfig

    smoke = args.lm_smoke
    out = report.setdefault("dryrun", {})
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_path = time.perf_counter()

    # ---- (a) counts on the (16, 16) meta slots: nothing allocated ----------
    cells = out["cells"] = {}
    for shape in DRYRUN_CELLS:
        t = time.perf_counter()
        r = DR.run_cell(DRYRUN_ARCH, shape, multi_pod=False, verbose=False)
        if r.get("status") != "ok":
            raise SystemExit(f"dryrun: {DRYRUN_ARCH} x {shape} did not count: {r}")
        cells[f"{DRYRUN_ARCH}:{shape}"] = dict(r, host_s=time.perf_counter() - t)
    for kind in ("build", "query"):
        t = time.perf_counter()
        r = CD.run(kind, False)
        cells[f"climber:{kind}"] = dict(r, host_s=time.perf_counter() - t)
    for name, r in cells.items():
        say(f"dryrun[{name} x 16x16 meta]: compute {r['compute_s']:.6g} s, memory "
            f"{r['memory_s']:.6g} s, collective {r['collective_s']:.6g} s, bottleneck "
            f"{r['bottleneck']}, roofline {r['roofline_fraction']:.4g}, args "
            f"{r['memory']['argument_bytes'] / 2**30:.3f} GiB/slot, host {r['host_s']:.1f} s")

    # ---- (b) one decode tick a card runs whole, counted then run ----------
    cfg = get_config(DRYRUN_ARCH, smoke=smoke)
    rows, ctx = (8, 256) if smoke else DRYRUN_TICK
    tick = ShapeConfig("decode_tick", ctx, rows, "decode")
    t = time.perf_counter()
    counter, _ = DR.lower_cell(cfg, tick, None, 2048)
    count_s = time.perf_counter() - t
    sizes = DR.argument_bytes(cfg, tick, None)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev), requested_bytes(dev)
    params = model.init(gen, dev)
    cache = init_cache(cfg, rows, ctx, device=dev)
    token = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - before[0]
    requested = requested_bytes(dev) - before[1]
    rounded = sum(-(-b // ALLOC_ROUND) * ALLOC_ROUND for b in sizes)
    # a block whose segment's tail is 1 MiB or less is not split: the
    # allocator then holds up to 1 MiB more than the rounded request
    slack = sum(ALLOC_SLACK for b in sizes if b >= ALLOC_SLACK)
    if requested != sum(sizes) or not rounded <= grown <= rounded + slack:
        raise SystemExit(f"dryrun: the counted argument bytes ({sum(sizes)}, {rounded} "
                         f"rounded to {ALLOC_ROUND} B a tensor) differ from the "
                         f"allocator's requested bytes {requested} or its growth {grown}")
    cache["len"] = ctx - 1
    with torch.no_grad():
        tick_ms = cuda_ms(lambda: decode_step(model, params, cache, token), iters=5)
    rep = RL.RooflineReport(
        arch=cfg.name, shape=f"decode {rows} x {ctx}", mesh="1",
        flops_per_device=counter.flops, bytes_per_device=counter.bytes,
        coll_bytes_per_device=0.0, coll_breakdown={},
        model_bytes_per_device=DR.model_bytes(cfg, tick, count_params(model.infos())))
    out["tick"] = {"rows": rows, "cache_tokens": ctx, "argument_bytes": sum(sizes),
                   "requested_bytes": requested, "argument_bytes_rounded": rounded,
                   "allocator_growth": grown,
                   "tensors": len(sizes), "count_s": count_s, "tick_ms": tick_ms,
                   "counted_bound_ms": rep.bound_s * 1e3, "bottleneck": rep.bottleneck,
                   "weights_cache_read_ms": rep.model_bytes_per_device / RL.HBM_BW * 1e3,
                   "counted_flops": counter.flops, "counted_bytes": counter.bytes,
                   "counted_peak_bytes": counter.peak_bytes}
    say(f"dryrun tick[{cfg.name}, {rows} rows x {ctx}-token cache, one card]: argument "
        f"bytes {sum(sizes)} ({len(sizes)} tensors) == the allocator's requested bytes "
        f"{requested}; its growth {grown} against {rounded} rounded to {ALLOC_ROUND} B a "
        f"tensor; " + json.dumps({a: (round(b, 4) if isinstance(b, float) else b)
                                   for a, b in out["tick"].items()}))
    del params, cache, token
    torch.cuda.empty_cache()

    # ---- (c) one slot's share of the CLIMBER steps, through the kernels ----
    ccfg = CD.CFG
    n, w, m, k, cap = (ccfg.series_len, ccfg.paa_segments, ccfg.prefix_len, ccfg.k,
                       ccfg.capacity)
    per = 20_000 if smoke else CD.N_SERIES // DRYRUN_SLOTS
    g = torch.Generator(device=dev).manual_seed(args.seed + 23)
    x = make_dataset("randomwalk", per, n, generator=g)
    skeleton = CD.synthetic_skeleton(ccfg, device=dev)
    pivots = torch.randn((ccfg.num_pivots, w), generator=g, device=dev)
    build = lambda: CD.build_step([x], pivots, skeleton, ccfg)
    part, dfs = build()[0]
    if not (part.shape == (per,) and bool((part >= 0).all())
            and bool((part < skeleton[0].num_partitions).all())):
        raise SystemExit("dryrun: the slot's build routed a record outside the skeleton")
    build_ms = cuda_ms(build, iters=3, warmup=1)
    # the slot's store: its ~166 partitions of cap rows, every record live
    p_slot = (CD.N_SERIES // cap) // DRYRUN_SLOTS if not smoke else per // cap
    store = x[:p_slot * cap].reshape(p_slot, cap, n).contiguous()
    norms = (store * store).sum(-1)
    rec_dfs = torch.zeros((p_slot, cap), dtype=torch.int32, device=dev)
    rec_gid = torch.arange(p_slot * cap, dtype=torch.int32, device=dev).reshape(p_slot, cap)
    q = make_queries(x, CD.N_QUERIES, generator=g).contiguous()
    # each query's plan: CD.PLAN_SLOTS distinct partitions of the slot,
    # sorted, whole (the meta count's rule: every entry a live partition)
    width = min(CD.PLAN_SLOTS, p_slot)
    sp = torch.sort(torch.argsort(torch.rand((q.shape[0], p_slot), generator=g,
                                             device=dev), dim=-1)[:, :width],
                    dim=-1).values.to(torch.int32).contiguous()
    lo = torch.zeros_like(sp)
    hi = torch.ones_like(sp)
    refine = lambda: ops.refine_topk(store, norms, rec_dfs, rec_gid, q, sp, lo, hi, k)
    query_ms = cuda_ms(refine, iters=5)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    missing = [a for a in DRYRUN_KERNELS if launches[a] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the dryrun path: {missing}")

    rows_q = q.shape[0] * width * cap
    meta_work = refine_topk_work(rows_q, rows_q, rows_q, q.shape[0], width, n, k)
    real = refine_work(rec_dfs, rec_gid, sp, lo, hi)
    share = {"records": per, "partitions": p_slot, "queries": q.shape[0], "plan_width": width,
             "build_ms": build_ms,
             "build_counted_bound_ms": counted_bound_ms(cells["climber:build"]),
             "query_refine_ms": query_ms,
             "query_counted_bound_ms": counted_bound_ms(cells["climber:query"]),
             "refine_meta_rule_bound_ms": work_bound(meta_work)[0],
             "refine_kept_records_bound_ms": refine_bound(real, q.shape[0], width, n, k)[0],
             "unique_kept_records": real["unique_kept_records"],
             "store_gb": store.numel() * 4 / 1e9}
    # the kernels against their plain versions at this path's shapes
    kc = {"paa": paa_row(x, w, iters=3, warmup=1)}
    z = ops.paa(x, w)
    kc["pivot_rank"] = pivot_rank_row(z, pivots, m, iters=3, warmup=1, plain_iters=2,
                                      plain_warmup=1)
    d2_k, g_k = refine()
    d2_p, g_p = refine_topk_plain(store, norms, rec_dfs, rec_gid, q, sp, lo, hi, k)
    tol = 1e-5 * ((q * q).sum(-1, keepdim=True) + float(norms.max()))
    err, differ = assert_same_topk("refine_topk [dryrun slot]", d2_k, g_k, d2_p, g_p, tol)
    bms, bby = refine_bound(real, q.shape[0], width, n, k)
    kc["refine_topk"] = {"max_abs_err": err, "gid_queries_differ": differ, "ms": query_ms,
                         "plain_ms": cuda_ms(lambda: refine_topk_plain(
                             store, norms, rec_dfs, rec_gid, q, sp, lo, hi, k), iters=2,
                             warmup=1),
                         "bound_ms": bms, "bound_by": bby, **real,
                         "shape": f"Q={q.shape[0]} MP={width} P={p_slot} cap={cap} n={n} "
                                  f"k={k}"}
    del d2_p, g_p, z
    out["slot"] = share
    out["kernels"] = kc
    out["seconds"] = time.perf_counter() - t_path
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    say(f"dryrun slot[1 of {DRYRUN_SLOTS}: {per} records, {p_slot} partitions, "
        f"{q.shape[0]} queries]: " + json.dumps(
            {a: (round(b, 4) if isinstance(b, float) else b) for a, b in share.items()}))
    for name, row in kc.items():
        say(f"{name} [dryrun slot]: " + json.dumps(
            {a: (round(b, 5) if isinstance(b, float) else b) for a, b in row.items()}))
    say(f"dryrun-path launches: {launches} ({out['seconds']:.1f} s, peak device memory "
        f"{out['peak_memory_gb']:.1f} GB)")
    del x, store, norms, rec_dfs, rec_gid, skeleton
    torch.cuda.empty_cache()
    return launches


PERF_ARCH = TRAIN_ARCH
PERF_LOSS_TOL = 5e-2                    # bf16 flash against fp32: the reference's rule
PERF_DECODE = (8, 256, 512, 8)          # rows, prompt tokens, cache tokens, ticks


def perf_path(args, dev, report):
    """The reference's perf switches on the card (module docstring, item
    11): the train step with ``set_flash_bf16`` off and on, and decode with
    ``set_cache_update_masked`` off and on.  Every hard check raises;
    every switch is left off.  Returns the path's launch counts (it runs
    none of the CLIMBER kernels)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import Model, decode_step, prefill
    from repro_torch.models import layers as L
    from repro_torch.models.layers import flash_attention
    from repro_torch.models.params import tree_map
    from repro_torch.train import AdamW, constant_lr, make_train_step

    smoke = args.lm_smoke
    seq = 64 if smoke else TRAIN_SEQ
    out = report.setdefault("perf", {"arch": PERF_ARCH, "seq": seq, "batch": TRAIN_BATCH,
                                     "microbatches": TRAIN_MICRO, "remat": "dots"})
    cfg = get_config(PERF_ARCH, smoke=smoke)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t_path = time.perf_counter()
    model = Model(cfg)
    init = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt = AdamW(lr=constant_lr(TRAIN_LR))
    step = make_train_step(model, opt, kv_chunk=TRAIN_KV_CHUNK, microbatches=TRAIN_MICRO)
    batch = TokenPipeline(cfg, TRAIN_BATCH, seq, seed=args.seed, mode="periodic",
                          device=dev).batch_at(0)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    shape = lambda h: (TRAIN_BATCH // TRAIN_MICRO, seq, h, cfg.head_dim)
    q, k, v = (torch.randn(shape(h), generator=g, device=dev).bfloat16().requires_grad_()
               for h in (cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))

    def attention():
        # one layer's flash at the step's shapes: forward twice (remat
        # recomputes it) and backward once
        with torch.no_grad():
            flash_attention(q, k, v, causal=True, kv_chunk=TRAIN_KV_CHUNK)
        o = flash_attention(q, k, v, causal=True, kv_chunk=TRAIN_KV_CHUNK)
        torch.autograd.grad(o, (q, k, v), torch.ones_like(o))

    runs = {}
    try:
        for flag in (False, True):
            L.set_flash_bf16(flag)
            p = tree_map(torch.clone, init)
            state = opt.init(p)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            (_, _, m1), s1 = sync_wall(lambda: step(p, state, batch))
            (_, _, m2), s2 = sync_wall(lambda: step(p, state, batch))
            peak = torch.cuda.max_memory_allocated() / 1e9
            del p, state
            torch.cuda.empty_cache()
            attention()
            _, attn_s = sync_wall(attention)
            runs["bf16" if flag else "fp32"] = {
                "loss": float(m1["loss"]), "loss_step2": float(m2["loss"]),
                "first_step_s": s1, "step_s": s2,
                "attention_s": attn_s * cfg.num_layers * TRAIN_MICRO, "peak_gb": peak}
    finally:
        L.set_flash_bf16(False)
    del q, k, v
    a, b = runs["fp32"], runs["bf16"]
    delta = max(abs(a["loss"] - b["loss"]), abs(a["loss_step2"] - b["loss_step2"]))
    out["flash_bf16"] = dict(runs, loss_delta=delta, tol=PERF_LOSS_TOL)
    say(f"perf flash_bf16[{cfg.name}, seq {seq}, batch {TRAIN_BATCH} = {TRAIN_MICRO} x "
        f"{TRAIN_BATCH // TRAIN_MICRO}, remat]: " + json.dumps(out["flash_bf16"], default=float))
    if not delta <= PERF_LOSS_TOL:
        raise SystemExit(f"perf: bf16 flash's loss differs from fp32's by {delta}")

    # ---- decode with the masked cache write off and on ---------------------
    rows, plen, max_len, ticks = (8, 32, 64, 4) if smoke else PERF_DECODE
    prompts = TokenPipeline(cfg, rows, plen, seed=args.seed, mode="periodic",
                            device=dev).batch_at(1)["tokens"][:, :plen]
    dec = {}
    with torch.no_grad():
        logits, cache = prefill(model, init, {"tokens": prompts}, max_len=max_len)
        first = logits[:, -1:].argmax(-1).to(torch.int32)
        try:
            for flag in (False, True):
                L.set_cache_update_masked(flag)
                decode_step(model, init, cache, first)            # warm-up tick
                c, tok, got = cache, first, []
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(ticks):
                    lg, c = decode_step(model, init, c, tok)
                    got.append(lg)
                    tok = lg[:, -1:].argmax(-1).to(torch.int32)
                torch.cuda.synchronize()
                dec["masked" if flag else "slice"] = {
                    "tick_ms": (time.perf_counter() - t) / ticks * 1e3, "logits": got}
        finally:
            L.set_cache_update_masked(False)
    equal = all(torch.equal(x, y) for x, y in zip(dec["slice"]["logits"],
                                                   dec["masked"]["logits"]))
    for r in dec.values():
        del r["logits"]
    out["masked_cache"] = dict(dec, rows=rows, prompt=plen, cache=max_len, ticks=ticks,
                               logits_bit_equal=equal)
    say(f"perf masked_cache[{cfg.name}, {rows} slots, {plen}-token prompts, {ticks} "
        f"ticks]: " + json.dumps(out["masked_cache"], default=float))
    if not equal:
        raise SystemExit("perf: the masked cache write changed the logits")
    del init, cache, logits, batch
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    out["seconds"] = time.perf_counter() - t_path
    out["peak_memory_gb"] = max(r["peak_gb"] for r in runs.values())
    say(f"perf-path launches: {launches} ({out['seconds']:.1f} s)")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num", type=int, default=4_194_304,
                    help="series in the dataset (the paper's scale, cut to one card)")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--other-num", type=int, default=1_048_576,
                    help="series in each of the sift/dna/eeg/seismic datasets")
    ap.add_argument("--tenant-shard", type=int, default=262_144,
                    help="series in each of the tenant corpus's 4 shards")
    ap.add_argument("--fleet-shard", type=int, default=1_048_576,
                    help="series in each of the fleet's 4 tenant shards")
    ap.add_argument("--frontier-shard", type=int, default=1_048_576,
                    help="series in each shard of the recall-frontier sweep")
    ap.add_argument("--lm-smoke", action="store_true",
                    help="smoke widths for every LM architecture, a datastore "
                         "of 2 steps, and a train path of 64-token sequences "
                         "for 6 steps (a CPU rehearsal)")
    ap.add_argument("--report", default=None,
                    help="also write the full JSON report to this path")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np
    from repro_torch.core.query import (knn_query, plan as plan_queries,
                                        register_recall_target)
    from repro_torch.core.index import build_index
    from repro_torch.core.refine import refine
    from repro_torch.data import make_dataset, make_queries
    from repro_torch.eval import (GroundTruthCache, hardness_split,
                                  mean_average_precision, perturbed_queries,
                                  recall_at_k, tenant_corpus)
    from repro_torch.kernels import _lib, ops
    from repro_torch.kernels.l2 import qdots_plain, qdots_work
    from repro_torch.kernels.refine_topk import (PARTITION_MAJOR_MIN, masked_distances,
                                                 refine_topk, refine_work, topk_flat)
    from repro_torch.serve import ClimberEngine
    from repro_torch.utils.config import ClimberConfig

    dev = torch.device("cuda", 0)
    report = {"args": vars(args)}

    # ---- card + kernel build -------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say(f"card: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t
    ptxas = ptxas_table(_lib.build_log())
    say(f"kernels: built/loaded libclimber_kernels.so in {build_s:.1f} s")
    for entry, v in ptxas.items():
        say(f"  ptxas {entry}: {v}")
    report["kernel_build_s"] = build_s
    report["ptxas"] = ptxas

    # ---- main path: data → build → serve, launch counts zeroed ----------
    cfg = ClimberConfig()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t = time.perf_counter()
    data = make_dataset("randomwalk", args.num, cfg.series_len, generator=gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t

    ops.reset_launch_counts()
    index = build_index(data, cfg, device=dev, generator=gen)
    store = index.store
    store_gb = sum(x.numel() * x.element_size() for x in store) / 1e9
    bs = {k: round(v, 3) for k, v in index.build_seconds.items()}
    say(f"build: N={args.num} n={cfg.series_len} P={store.num_partitions} "
        f"cap={store.capacity} G={index.num_groups} "
        f"trie_nodes={index.forest.num_nodes} store_gb={store_gb:.3f} "
        f"raw_gb={data.numel() * 4 / 1e9:.3f} datagen_s={gen_s:.2f} steps_s={bs}")
    report["build"] = {"N": args.num, "P": store.num_partitions,
                       "cap": store.capacity, "G": index.num_groups,
                       "trie_nodes": index.forest.num_nodes,
                       "store_gb": store_gb, "seconds": index.build_seconds,
                       "datagen_s": gen_s}

    queries = make_queries(data, args.queries, generator=gen)
    serve = {}
    engines = {}
    for variant, nq in (("adaptive", args.queries), ("knn", 64),
                        ("od_smallest", 64)):
        eng = ClimberEngine(index, batch_size=64, variant=variant, k=cfg.k)
        eng.run(queries[:64].cpu().numpy())          # warm-up tick
        eng.reset_metrics()
        dist, gid, _ = eng.run(queries[:nq].cpu().numpy())
        st = eng.stats
        row = {"queries": st.queries, "ticks": st.ticks,
               "qps": st.queries_per_sec,
               "featurize_ms": st.featurize_s / st.ticks * 1e3,
               "plan_ms": st.plan_s / st.ticks * 1e3,
               "refine_ms": st.refine_s / st.ticks * 1e3,
               "tick_ms": st.total_s / st.ticks * 1e3,
               "mean_partitions_touched": st.mean_partitions_touched,
               "mean_candidates_scanned": st.mean_candidates_scanned}
        serve[variant] = row
        engines[variant] = (eng, dist, gid)
        say(f"serve[{variant}]: " + json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v) for k, v in row.items()}))
    # the benchmark's tick: 4,096 queries in one adaptive tick, whose plan
    # names each planned partition for enough queries that refine_topk
    # takes the partition-major design
    q_tick = make_queries(data, TICK_QUERIES, generator=torch.Generator(
        device=dev).manual_seed(args.seed + TICK_QUERIES)).contiguous()
    eng_t = ClimberEngine(index, batch_size=TICK_QUERIES, variant="adaptive", k=cfg.k)
    sp_t, lo_t, hi_t = eng_t._plan(eng_t._featurize(q_tick))[:3]
    if TICK_QUERIES * sp_t.shape[1] < PARTITION_MAJOR_MIN * store.num_partitions:
        raise SystemExit(f"the {TICK_QUERIES}-query tick's plan (MP={sp_t.shape[1]}, "
                         f"P={store.num_partitions}) is below the partition-major rule")
    dist_t, _, _ = eng_t.run(q_tick.cpu().numpy())
    st_t = eng_t.stats
    serve["adaptive_b4096"] = {"queries": st_t.queries, "ticks": st_t.ticks,
                               "refine_ms": st_t.refine_s / st_t.ticks * 1e3,
                               "tick_ms": st_t.total_s / st_t.ticks * 1e3,
                               "entries_per_partition":
                                   TICK_QUERIES * sp_t.shape[1] / store.num_partitions}
    say("serve[adaptive_b4096]: " + json.dumps(serve["adaptive_b4096"], default=float))
    if not np.isfinite(dist_t).all():
        raise SystemExit("the 4,096-query tick's answers are not finite")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    say(f"serve-path launches: {launches}")
    report["serve"] = serve
    report["launches_serve"] = launches
    missing = [k for k in SERVE_KERNELS if launches[k] <= 0]
    pm = launches["refine_topk.partition_major"]
    if pm <= 0 or launches["refine_topk"] - pm <= 0:
        missing.append(f"refine_topk by design: {pm} partition-major of "
                       f"{launches['refine_topk']}")
    if missing:
        raise SystemExit(f"kernels not launched on the serve path: {missing}")
    report["refine_checks_serve"] = refine_plan_checks(
        "serve", q_tick, cfg.k, [("adaptive b4096", store, (sp_t, lo_t, hi_t))])
    del eng_t, sp_t, lo_t, hi_t, dist_t

    # ---- where one serving tick's time goes (a separate, traced tick) -----
    from torch.profiler import ProfilerActivity, profile
    eng_p = ClimberEngine(index, batch_size=64, variant="adaptive", k=cfg.k)
    eng_p.run(queries[:64].cpu().numpy())                # warm-up, fills its cache
    qb = queries[64:128].cpu().numpy()                   # not cached: a full tick
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        eng_p.run(qb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side events only (kernels, copies): a CPU op's device time is
    # its kernels' time again
    dev_ms, dev_calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms[e.name] = dev_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            dev_calls[e.name] = dev_calls.get(e.name, 0) + 1
    dev_rows = sorted(((n, ms, dev_calls[n]) for n, ms in dev_ms.items()),
                      key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in dev_rows)
    prof_report = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                   "device_kernel_kinds": len(dev_rows),
                   "top": [{"name": n[:80], "ms": ms, "calls": c}
                           for n, ms, c in dev_rows[:12]]}
    if dev_rows:
        prof_report["idle_share"] = 1.0 - busy_ms / wall_ms
        say(f"profile (one adaptive tick of 64, traced): wall {wall_ms:.3f} ms, "
            f"device busy {busy_ms:.3f} ms over {len(dev_rows)} kernel kinds, idle share "
            f"{prof_report['idle_share']:.3f}; top: "
            + "; ".join(f"{n[:40]} {ms:.3f} ms x{c}" for n, ms, c in dev_rows[:5]))
    else:
        say("profile: the profiler reported no device time (idle share not measured)")
    report["profile_tick"] = prof_report

    # ---- answers: engine ≡ per-query knn_query; finite, right shape ------
    eng, dist, gid = engines["adaptive"]
    if dist.shape != (args.queries, cfg.k) or not np.isfinite(dist).all():
        raise SystemExit(f"engine answers malformed: {dist.shape}")
    for i in range(8):
        d1, g1, _ = knn_query(index, queries[i:i + 1], cfg.k, variant="adaptive")
        if not (np.array_equal(g1.cpu().numpy()[0], gid[i])
                and np.array_equal(d1.cpu().numpy()[0], dist[i])):
            raise SystemExit(f"engine answer {i} differs from knn_query")
    say("engine == per-query knn_query on 8 queries (dist and gid bit-equal)")

    # ---- evaluation path (Fig. 7), launch counts zeroed ------------------
    register_recall_target(2.0)          # the "recall_target" variant, spend 2
    (ROOT / "build").mkdir(exist_ok=True)
    gt_dir = Path(tempfile.mkdtemp(prefix="smoke_gt_", dir=ROOT / "build"))
    q64 = queries[:EVAL_QUERIES].contiguous()
    fig7 = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_eval = time.perf_counter()
    try:
        gt_cache = GroundTruthCache(gt_dir)
        rows, (gt_d, gt_i) = evaluate_dataset(
            "randomwalk", data, q64, index, gt_cache,
            {"name": "randomwalk", "seed": args.seed, "series_len": cfg.series_len},
            cfg, gen)
        fig7 += rows
        for j, name in enumerate(("sift", "dna", "eeg", "seismic")):
            g_o = torch.Generator(device=dev).manual_seed(args.seed + 1 + j)
            t = time.perf_counter()
            x_o = make_dataset(name, args.other_num, cfg.series_len, generator=g_o)
            q_o = make_queries(x_o, EVAL_QUERIES, generator=g_o).contiguous()
            idx_o = build_index(x_o, cfg, device=dev, generator=g_o)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            say(f"dataset[{name}]: N={args.other_num} (cut from the paper's "
                f"10^8-10^9 to one card) generated and CLIMBER-indexed in {secs:.2f} s: "
                f"P={idx_o.store.num_partitions} cap={idx_o.store.capacity} "
                f"store_gb={idx_o.store.data.numel() * 4 / 1e9:.3f} "
                f"steps_s={ {a: round(b, 3) for a, b in idx_o.build_seconds.items()} }")
            rows, _ = evaluate_dataset(
                name, x_o, q_o, idx_o, gt_cache,
                {"name": name, "seed": args.seed + 1 + j, "series_len": cfg.series_len},
                cfg, g_o)
            fig7 += rows
            del x_o, q_o, idx_o
            torch.cuda.empty_cache()

        # a tenant corpus: perturbed queries, 2K true neighbours, hard/easy
        shards = 4
        t = time.perf_counter()
        corpus = tenant_corpus("seismic", num_shards=shards,
                               shard_size=args.tenant_shard,
                               series_len=cfg.series_len, seed=args.seed,
                               affinity=0.6, device=dev)
        tq = perturbed_queries(corpus, EVAL_QUERIES, noise=0.1, seed=args.seed)
        union = corpus.union
        t_meta = dict(corpus.meta(), queries={"num": EVAL_QUERIES, "noise": 0.1,
                                              "seed": args.seed})
        t_d, t_i = gt_cache.exact(t_meta, tq, union, 2 * cfg.k, chunk=SCAN_CHUNK)
        hard, easy = hardness_split(t_d, cfg.k)
        g_t = torch.Generator(device=dev).manual_seed(args.seed + 9)
        t_index = build_index(union, cfg, device=dev, generator=g_t)
        d_t, gid_t, _ = knn_query(t_index, tq, cfg.k, variant="adaptive")
        d_t, gid_t = d_t.cpu().numpy(), gid_t.cpu().numpy()
        tenant = {"shards": shards, "shard_size": args.tenant_shard,
                  "affinity": 0.6, "noise": 0.1, "seconds": time.perf_counter() - t}
        for half, sel in (("hard", hard), ("easy", easy), ("all", np.arange(EVAL_QUERIES))):
            tenant[f"recall_{half}"] = recall_at_k(
                gid_t[sel], t_i[sel, :cfg.k], cfg.k, approx_dist=d_t[sel],
                exact_dist=t_d[sel, :cfg.k])
            tenant[f"map_{half}"] = mean_average_precision(gid_t[sel], t_i[sel, :cfg.k], cfg.k)
        tenant["contrast_median"] = float(np.median(t_d[:, 2 * cfg.k - 1]
                                                    / np.maximum(t_d[:, cfg.k - 1], 1e-12)))
        say(f"tenant[seismic x{shards}, {args.tenant_shard} each, affinity 0.6, "
            f"noise 0.1]: " + json.dumps({a: (round(b, 4) if isinstance(b, float) else b)
                                          for a, b in tenant.items()}))
        del corpus, union, t_index
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(gt_dir, ignore_errors=True)
    eval_launches = ops.launch_counts()
    eval_s = time.perf_counter() - t_eval
    say(f"eval-path launches: {eval_launches} ({eval_s:.1f} s)")
    report["fig7"] = fig7
    report["tenant"] = tenant
    report["launches_eval"] = eval_launches
    report["eval_seconds"] = eval_s
    missing = [k for k in EVAL_KERNELS if eval_launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the evaluation path: {missing}")
    torch.cuda.empty_cache()

    # the exhaustive plan through the same kernel must give the Dss answer,
    # up to ties at the k-th distance
    exact = gt_i
    kth = gt_d[:, -1].astype(np.float64) ** 2
    q2 = (q64 * q64).sum(-1, keepdim=True)
    d_ex, g_ex, _ = knn_query(index, q64, cfg.k, variant="exhaustive")
    d2_ex = (d_ex.double() ** 2).cpu().numpy()
    g_ex = g_ex.cpu().numpy()
    tol_ex = 1e-5 * (q2[:, 0].double().cpu().numpy() + float(store.norms.max()))
    hits = 0
    for i in range(EVAL_QUERIES):
        extra = ~np.isin(g_ex[i], exact[i])
        hits += cfg.k - int(extra.sum())
        if (np.abs(d2_ex[i][extra] - kth[i]) > tol_ex[i]).any():
            raise SystemExit(f"exhaustive query {i} misses the Dss answer")
    say(f"recall@{cfg.k} (exhaustive through refine_topk vs Dss, {EVAL_QUERIES} "
        f"queries): {hits / (EVAL_QUERIES * cfg.k):.4f} (misses only at "
        f"k-th-distance ties)")
    report["recall_at_k_exhaustive"] = hits / (EVAL_QUERIES * cfg.k)

    # ---- kernels vs plain versions, at the main path's shapes -----------
    def ptxas_of(kernel):
        return {e: v for e, v in ptxas.items() if kernel in e}

    kernels = []
    w, n, m, k = cfg.paa_segments, cfg.series_len, cfg.prefix_len, cfg.k

    # paa at the build's step-4 width (the whole dataset in one call)
    kernels.append(dict(
        name="paa", route="cuda", source="src/repro_torch/csrc/paa.cu",
        replaces="src/repro/kernels/paa_kernel.py:42", launches=launches["paa"],
        **paa_row(data, w), ptxas=ptxas_of("paa_kernel")))
    # and at the serving shape: one tick's featurize, 64 query rows
    kernels[-1]["tick_shape"] = paa_row(q64, w, 50, 5, tick=True)
    say(f"paa at [64,{n}]: {json.dumps(kernels[-1]['tick_shape'])}")

    # pivot_rank over the dataset's PAA rows (step 4's work in one call)
    piv = index.pivots
    z_k = ops.paa(data, w)
    kernels.append(dict(
        name="pivot_rank", route="cuda", source="src/repro_torch/csrc/pivot_rank.cu",
        replaces="src/repro/kernels/pivot_rank.py:59", launches=launches["pivot_rank"],
        **pivot_rank_row(z_k, piv, m, plain_iters=2, plain_warmup=1),
        ptxas=ptxas_of(f"pivot_rank_kernel<{w},")))
    del z_k
    # and at the serving shape: one tick's featurize, 64 query rows
    z64 = ops.paa(q64, w)
    kernels[-1]["serve_shape"] = pivot_rank_row(z64, piv, m, 50, 5, 50, 5)
    say(f"pivot_rank at [64,{w}]: {json.dumps(kernels[-1]['serve_shape'])}")

    # refine_topk on three plans: one serving tick (queries 0-63, adaptive),
    # the traced tick's batch (64-127) and od_smallest (0-63), each sorted by
    # partition at its full width and held against the plain version on the
    # plan compacted to its live width (pads sort first, so the last columns
    # hold every live entry in the same relative order)
    cap = store.capacity

    def refine_plan(qs, variant):
        p4r, _ = index.featurize(qs)
        qp = plan_queries(index, p4r, variant=variant)
        order = torch.argsort(qp.sel_part, dim=-1, stable=True)
        sp, lo_, hi_ = (torch.gather(t_, 1, order).contiguous()
                        for t_ in (qp.sel_part, qp.sel_lo, qp.sel_hi))
        live_w = int((sp >= 0).sum(1).max())
        return sp, lo_, hi_, live_w

    def plain_refine(qs, sp, lo_, hi_, live_w):
        qc = max(1, int(2e9 // (live_w * cap * n * 4)))
        outs = [topk_flat(*masked_distances(
            store.data, store.norms, store.rec_dfs, store.rec_gid, qs[a:a + qc],
            sp[a:a + qc, -live_w:], lo_[a:a + qc, -live_w:], hi_[a:a + qc, -live_w:]), k)
            for a in range(0, qs.shape[0], qc)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    xmax = float(store.norms.max())
    rt_plans, rt_err = {}, 0.0
    for label, qs, variant in (("adaptive q0-63", q64, "adaptive"),
                               ("adaptive q64-127 (traced tick)",
                                queries[64:128].contiguous(), "adaptive"),
                               ("od_smallest q0-63", q64, "od_smallest")):
        sp, lo_, hi_, live_w = refine_plan(qs, variant)
        d2_k, g_k = refine_topk(store.data, store.norms, store.rec_dfs,
                                store.rec_gid, qs, sp, lo_, hi_, k)
        d2_p, g_p = plain_refine(qs, sp, lo_, hi_, live_w)
        tol = 1e-5 * ((qs * qs).sum(-1, keepdim=True) + xmax)
        err, differ = assert_same_topk(f"refine_topk [{label}]", d2_k, g_k, d2_p, g_p, tol)
        rt_err = max(rt_err, err)
        del d2_p, g_p
        work = refine_work(store.rec_dfs, store.rec_gid, sp[:, -live_w:],
                           lo_[:, -live_w:], hi_[:, -live_w:])
        mp = sp.shape[1]
        bms, bby = refine_bound(work, qs.shape[0], mp, n, k)
        rt_plans[label] = dict(
            work, mp=mp, live_width=live_w, max_abs_err=err, gid_queries_differ=differ,
            ms=cuda_ms(lambda: refine_topk(store.data, store.norms, store.rec_dfs,
                                           store.rec_gid, qs, sp, lo_, hi_, k)),
            device_ms=device_ms(lambda: refine_topk(store.data, store.norms, store.rec_dfs,
                                                    store.rec_gid, qs, sp, lo_, hi_, k),
                                "refine", iters=5),
            bound_ms=bms, bound_by=bby)
        say(f"refine_topk [{label}]: max |Δd²| {err:.3g}; {differ} of {qs.shape[0]} "
            f"queries differ in gid order at near-ties; " + json.dumps(
                {a: (round(b, 4) if isinstance(b, float) else b)
                 for a, b in rt_plans[label].items()}))
        if label.startswith("adaptive q0-63"):
            main_plan = (sp, lo_, hi_, live_w)
    sp, lo_, hi_, live_w = main_plan
    spc, loc, hic = sp[:, -live_w:], lo_[:, -live_w:], hi_[:, -live_w:]
    qc = max(1, int(2e9 // (live_w * cap * n * 4)))
    q2v = (q64 * q64).sum(-1, keepdim=True)
    main = rt_plans["adaptive q0-63"]
    kernels.append({
        "name": "refine_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/refine_topk.cu",
        "replaces": "src/repro/kernels/refine_topk.py:189",
        "launches": launches["refine_topk"], "max_abs_err": rt_err,
        "ms": main["ms"],
        "plain_ms": cuda_ms(lambda: plain_refine(q64, sp, lo_, hi_, live_w),
                            iters=2, warmup=1),
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"], "library_ms": None,
        "kept_pairs": main["kept_pairs"],
        "unique_kept_records": main["unique_kept_records"],
        "shape": f"Q=64 MP={sp.shape[1]} (live {live_w}) cap={cap} n={n} k={k}",
        "plans": rt_plans,
        "ptxas": ptxas_of("refine_")})

    for row in kernels:
        row["path"] = "serve"

    # pairwise_l2 on one Dss chunk: 64 queries x 2^20 series
    x_c = data[:SCAN_CHUNK]
    kernels.append(dict(
        name="pairwise_l2", route="cuda", source="src/repro_torch/csrc/l2.cu",
        replaces="src/repro/kernels/l2.py:60", path="eval",
        launches=eval_launches["pairwise_l2"], **pairwise_l2_row(q64, x_c, "pairwise_l2"),
        ptxas=ptxas_of("pairwise_l2_kernel")))
    say(f"pairwise_l2: max |Δd²| {kernels[-1]['max_abs_err']:.3g} over "
        f"{kernels[-1]['shape']}")

    # qdots on the rows of the adaptive plan above, compacted to its live
    # width, for the first qc queries (about 2 GB of rows)
    pid = spc[:qc].clamp(min=0).long()
    q_r = pid.shape[0]
    rows_q = store.data[pid].reshape(q_r, live_w * cap, n)
    qq = q64[:q_r].contiguous()
    o_k = ops.qdots(qq, rows_q)
    o_p = qdots_plain(qq, rows_q)
    tol = 1e-5 * (q2v[:q_r] + store.norms[pid].reshape(q_r, -1))
    qd_err = (o_k - o_p).abs()
    if bool((qd_err > tol).any()):
        raise SystemExit(f"qdots: |Δ| {float(qd_err.max())} exceeds 1e-5·(‖q‖²+‖x‖²)")
    qd_err = float(qd_err.max())
    del o_k, o_p, tol
    # and the dense refine on the card (qdots) against the fused kernel
    (d_dn, g_dn), dense_s = sync_wall(lambda: refine(store, q64, spc, loc, hic, k,
                                                     use_kernel=False))
    (d_fu, g_fu), fused_s = sync_wall(lambda: refine(store, q64, spc, loc, hic, k,
                                                     use_kernel=True))
    dn_err, dn_differ = assert_same_topk("dense refine (qdots) vs fused",
                                         d_dn.double() ** 2, g_dn,
                                         d_fu.double() ** 2, g_fu, tol=1e-5 * (q2v.double() + xmax))
    say(f"qdots: max |Δ| {qd_err:.3g} over [{q_r}, {live_w * cap}, {n}]; dense refine "
        f"(qdots) vs fused refine_topk on the live-width adaptive plan: max |Δd²| "
        f"{dn_err:.3g}, {dn_differ} of 64 queries differ at near-ties "
        f"({dense_s * 1e3:.1f} ms vs {fused_s * 1e3:.1f} ms)")
    c_r = live_w * cap
    bms, bby = work_bound(qdots_work(q_r, c_r, n))
    kernels.append({
        "name": "qdots", "route": "cuda", "source": "src/repro_torch/csrc/l2.cu",
        "replaces": "src/repro/kernels/l2.py:100", "path": "eval",
        "launches": eval_launches["qdots"], "max_abs_err": qd_err,
        # kernel and library in turns, 20 launches each: they differ by a
        # few percent, about the spread of one timing
        "ms": cuda_ms(lambda: ops.qdots(qq, rows_q), iters=20),
        "plain_ms": cuda_ms(lambda: qdots_plain(qq, rows_q)),
        "bound_ms": bms, "bound_by": bby,
        "library_ms": cuda_ms(lambda: torch.bmm(rows_q, qq[:, :, None]), iters=20),
        "ms_again": cuda_ms(lambda: ops.qdots(qq, rows_q), iters=20),
        "library_ms_again": cuda_ms(lambda: torch.bmm(rows_q, qq[:, :, None]), iters=20),
        "library_call": "torch.bmm(rows, q[:, :, None])",
        "dense_refine_ms": dense_s * 1e3, "fused_refine_ms": fused_s * 1e3,
        "dense_vs_fused_max_abs_err": dn_err,
        "shape": f"q [{q_r},{n}], rows [{q_r},{c_r},{n}] -> [{q_r},{c_r}]",
        "ptxas": ptxas_of("qdots")})
    del rows_q

    # ---- fleet path, launch counts zeroed (the serve data and index stay
    # for the mesh path) ----------------------------------------------------
    del store, engines, eng, eng_p, x_c, z64, sp, lo_, hi_, spc, loc, hic
    del main_plan, d_dn, g_dn, d_fu, g_fu, qq
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9       # serve + eval + kernels
    fleet_launches, net_launches, fleet = fleet_path(args, dev, cfg, report)
    peak_gb = max(peak_gb, report["fleet"]["peak_memory_gb_with_checks"])

    # ---- device mesh, launch counts zeroed (the fleet and the serve index
    # go after it) ------------------------------------------------------------
    mesh_launches = mesh_path(args, dev, cfg, report, index, queries, data, fleet)
    peak_gb = max(peak_gb, report["mesh"]["peak_memory_gb"])
    del fleet, data, index
    torch.cuda.empty_cache()

    # ---- recall frontier, launch counts zeroed (the fleet is gone) -------
    frontier_launches = frontier_path(args, dev, cfg, report)
    peak_gb = max(peak_gb, report["frontier"]["peak_memory_gb"])

    # ---- the LM serving plane, launch counts zeroed (every earlier path's
    # data is gone) ------------------------------------------------------------
    lm_launches = lm_path(args, dev, report)
    peak_gb = max(peak_gb, report["lm"]["peak_memory_gb"])

    # ---- the model axis, launch counts zeroed (the lm path's weights are
    # gone; its own are freed before the training plane) ----------------------
    tp_launches = tp_path(args, dev, report)
    peak_gb = max(peak_gb, report["tp"]["peak_memory_gb"])

    # ---- the training plane, launch counts zeroed (the lm path's weights
    # are gone) ---------------------------------------------------------------
    train_launches = train_path(args, dev, report)
    peak_gb = max(peak_gb, report["train"]["peak_memory_gb"])

    # ---- the dry-run tools, launch counts zeroed ------------------------------
    dryrun_launches = dryrun_path(args, dev, report)
    peak_gb = max(peak_gb, report["dryrun"]["peak_memory_gb"])

    # ---- the perf switches, launch counts zeroed ------------------------------
    perf_launches = perf_path(args, dev, report)
    peak_gb = max(peak_gb, report["perf"]["peak_memory_gb"])
    # the paths' own shapes, checked against the plain versions after each
    # path's counts were read: their errors join the kernel rows
    for row in kernels:
        if row["name"] == "refine_topk":
            for path in ("fleet", "net", "mesh", "frontier"):
                row[f"{path}_plans"] = report[path]["refine_checks"]
                row["max_abs_err"] = max([row["max_abs_err"]] + [
                    c["max_abs_err"] for c in row[f"{path}_plans"].values()])
        if row["name"] == "pairwise_l2":
            row["frontier_chunk"] = report["frontier"]["l2_check"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     row["frontier_chunk"]["max_abs_err"])
        if row["name"] in DRYRUN_KERNELS:
            row["dryrun_shape"] = report["dryrun"]["kernels"][row["name"]]
            row["max_abs_err"] = max(row["max_abs_err"], row["dryrun_shape"]["max_abs_err"])
        if row["name"] in LM_KERNELS:
            lm = report["lm"]["kernels"][row["name"]]
            row["lm_shape"] = lm
            row["max_abs_err"] = max([row["max_abs_err"], lm["max_abs_err"]]
                                     + [lm.get("queries", lm)["max_abs_err"]])
    say(f"peak device memory of the smoke: {peak_gb:.1f} GB")
    by_path = {"serve": launches, "eval": eval_launches, "fleet": fleet_launches,
               "net": net_launches, "mesh": mesh_launches,
               "frontier": frontier_launches, "lm": lm_launches,
               "tp": tp_launches, "train": train_launches, "dryrun": dryrun_launches,
               "perf": perf_launches}
    for row in kernels:
        row["launches_by_path"] = {p_: c[row["name"]] for p_, c in by_path.items()}

    line = json.dumps({"kernels": kernels})
    report["kernels"] = kernels
    report["max_memory_allocated_gb"] = peak_gb
    report["card"] = smi
    if args.report:
        path = Path(args.report)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(report, indent=2))
    say(line)
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
