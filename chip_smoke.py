#!/usr/bin/env python3
"""Drive the apsu_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed S] [--profile]

Phases, each printing one JSON object per line:

1. the card (``nvidia-smi`` name and power limit) and the kernel build
   (``nvcc`` for ``sm_90a``, every ``csrc/*.cu`` in parallel);
2. each hand-written kernel against its plain PyTorch version on CUDA tensors,
   bit for bit, at the shapes of the paths (NTT: eval, query, Bsk, key
   and plain-modulus bases of 16M-4096 at N=8192 plus a 30-bit prime at
   N=4096; PS inner sums: one eval chunk of the 4-bundle x 6-cache cache,
   the 1M-4096-com eval shape on its 30-bit primes, and ph=311 on 256M-1's
   eval primes; the dot product at its ``DOT_CASES``: the 1M-2048-cmp warm
   query's shape on its primes and on 30-bit primes, the labeled 1M-1-32
   shape, a 5-shard 1M-2048-cmp shard, 520 planes on 30-bit primes, and
   the 1M-256-288 warm query's shape; the mask draw M1 at both benchmark
   cells' mask shapes, for the mask's range and the labeled path's rho,
   from counters that carry across 2^32 and 2^64, each shape timed beside
   its bound by bytes, integer operations and shared-memory words, the
   kept draw (the kernel also storing the words into pinned host memory)
   beside that bound and the host link's, and the host's cost of one kept
   draw);
3. the ceilings: the ceiling probe (``vpu_loop``, K9) and the per-call floor
   (``add_one``, K10) against their plain versions, bit for bit; then the
   port's two measuring tools (``apsu_tpu_torch.tools.vpu_roofline``: the
   streaming rate, ``torch.add``'s, and each product's rate with its SASS
   count; ``apsu_tpu_torch.tools.ntt4p_gl_ab``: K1 against K10's graph and
   eager floors over the reference's grid), each with the launch counts set
   to 0 before it and read after, and the ``ceilings`` line; a measured rate
   above 105% of its published figure raises.  K1-K3's ``ceiling_ms`` in
   the last line comes from these rates;
4. the PS path at full width: a dense synthetic 16M-4096 ReceiverDB
   (B=4, C=6, cache [4, 6, 1312, 4, 8192] int32 on the card), one encrypted
   query with a relinearization key, ``Receiver.run_query`` once cold (its
   two programs captured into CUDA graphs, ``engine/programs.py``), three
   times warm (replayed), once under ``programs.eager()`` with every kernel
   call recorded (phases 6, 7, 11 and 14 record the same way: a replay
   calls no wrapper) and once replayed with the in-call split, then the
   planted-match oracle on every response: each planted match decrypts to
   that query's mask and no non-match does (and, as a control, a response
   checked against another query's mask must fail); the launches per query
   are a replayed query's, which counts what an eager one launches; then a
   ``CsRng`` receiver runs the query WARM + 1 times with M1's launch count
   set to 0: each mask is one launch, equals the host draw of its stream
   and passes the oracle (``csrng_path``);
5. the kernels again against their plain versions at every shape the
   recorded PS query launched them with, and their per-query device time and bound;
   the glue kernels G1-G5 (``ops/behz.py``) at every call of that query, on
   the inputs it gave them (fresh copies for each run: G5 writes in place), each distinct call then timed by graph replay
   beside its bound and the measured ceilings (phases 6, 7, 11, 12 and 14
   do the same for their warm or recorded queries; phases 4, 6, 11 and 12
   fail if a glue kernel never launched, and every such check fails if G3
   or the lift took its general build); each call's inputs are copied with
   their own strides, so what is checked and timed is the layout the query
   passed; phase 1 reports each build of G3 and the lift with its registers
   and spills (``glue_builds``);
6. the in-process PSU at full width on 1M-2048-cmp: 2^20 receiver items
   through ``ReceiverDB.set_data`` (cache [5, 15, 80, 2, 4096] on the card),
   a 2048-item ``Sender`` query of which 1024 items are in the DB, and
   ``run_psu``, checked by set algebra (transferred == query - db, union ==
   db | query); then ``Receiver.run_query`` on that request once cold and
   three times warm, each response decrypted and run through the endgame
   against its own mask (exact) and, as a control, one against another
   query's mask (must fail); then the NTT and dot-product kernels against
   their plain versions at the shapes the warm query launched them with;
7. the same on the PS set 1M-2048-com (29, 29 and 28-bit eval primes, which
   the PS inner sums take since they fold their u64 sums), with the NTT and
   PS inner-sum kernels checked at the warm query's shapes;
8. the real protocol in one process, ``run_psu_mpc`` at 1M-2048-cmp, full
   width: 2^20 DB items, 2048 query items of which 1024 are in the DB, the
   KKRT OPRF during the DB build, the DDH PEQT and the OT of the difference
   set, both parties on the card; the set algebra (and, as a control, the
   union against another query's set, which must fail), the phase times,
   bytes on the wire, the OT flavours used, each kernel's launches, and the
   kernels against their plain versions at the shapes this run launched;
9. the two-process CLI on the card at 1M-2048-com: ``receiver_cli --serve 2``
   on 2^20 CSV items and ``sender_cli --peqt osn`` with two 2048-item query
   files on one TCP connection to a free localhost port, so the second query
   goes through OP_REBIND; each union.csv against the set algebra of the
   CSVs, the receiver's timings (``rebind`` among them), its device memory
   around the rebind (the consumed cache freed first) and its peak, both
   processes' kernel launches and OT flavours, and the kernels against their
   plain versions at every call either process made (each process runs its
   CLI module under ``chip_smoke.py --cli-child RECORD MODULE ARGS``, which
   records each call's shapes, strides and primes);
10. the receiver DB's lifecycle at 1M-2048-com (PS): ``set_data`` of 2^20
   items under a non-default location seed (the ``Sender`` takes the same),
   ``has_item`` on 1024 present and 1024 absent items, ``insert_or_assign``
   of 2^14 new items (128 of them on the fullest slot, so that the cache axis
   grows and the whole cache is rebuilt, the old one released first) and
   ``remove`` of 2^14 old ones, ``run_psu`` with a 2048-item sender (1024 in
   the final set, 64 of them inserted, and 64 removed items) against the
   final set's algebra, with the removed items checked as members as a
   control that must fail; then ``strip``, ``save`` to a temporary directory
   in the checkout and ``load`` on the card: the loaded DB's response to a
   seeded query equals the stripped DB's bit for bit, and the stripped DB
   refuses ``insert_or_assign``; then ``place_data`` + ``build_partition((0,
   5))`` against a direct ``cache_range=(0, 5)`` build, bit for bit; and the
   kernels against their plain versions at every call the phase made;
11. labeled mode at 1M-1-32 (non-PS, N=8192; the largest non-PS set whose
   labels decrypt exactly, in either package): 2^20 items with 10-byte
   labels (one in 64 encrypted with ``encrypt_label`` under a public nonce),
   built at ``labeled_eval_level()``; a 1536-item query (1024 in the DB, all
   on distinct slots, as the set's one location function needs) once cold
   and three times warm, each with its own mask: every matched item returns
   exactly its label (the encrypted ones decrypt to theirs), no other item
   matches, and, as a control, a response read against another query's mask
   fails; the labeled DB refuses ``insert_or_assign``; K3 launched twice a
   query (the matching and the label cache), held against its plain version
   at both calls of the last warm query, and the NTT at its shapes;
12. the sharded receiver (``parallel/runtime.py``), run right after phase 5
   on phase 4's 16M-4096 DB and right after phase 6 on its 1M-2048-cmp DB
   (``sharded_path``): ``ShardedReceiver`` on a 1-shard mesh (the one-card
   deployment) timed in turns with ``Receiver.run_query`` under
   ``programs.eager()`` (the mesh path has no programs), and on a 5-shard
   mesh on the one card (16M-4096's 24 rows as 5/5/5/5/4; a check of the
   partition, not a deployment time); every response bit for bit equal to
   the direct one under the same mask seed and exact by the set's oracle
   (a control against another mask must fail); the launches of each
   sharded query, and the kernels against their plain versions at every
   call of a 5-shard query;
13. the worker grid at 1M-2048-com through the four CLIs (``grid_path``):
   four ``worker_cli`` processes on ``--port 0`` (bundles (0,3)/(3,5) ×
   two cache ranges of the global C), one ``receiver_cli --workers ...
   --cache-parts 2 --serve 2`` coordinator and one ``sender_cli --peqt
   osn`` with two query files (KKRT; the second query rebinds every
   worker); both unions against the set algebra with a control, each
   worker's build and rebind time, link bytes, peak device memory and its
   log line that the consumed cache went first, the coordinator's
   ``dist_*`` split, and the kernels at every call the six processes made;
14. the in-process PSU at full width on 1M-256-288 (non-PS, N=4096, K=512:
   the dot product over 520 planes): 2^20 receiver items, a 256-item
   ``Sender`` query of which 128 items are in the DB, ``run_psu`` and the
   warm queries checked as in phase 6, K3 held against its plain version at
   the shape the warm query launched it with;
15. the query's programs (``programs_path``), run at the end of phases 4-5
   (16M-4096), 6 (1M-2048-cmp), 7 (1M-2048-com), 11 (labeled 1M-1-32) and
   14 (1M-256-288) on their DBs and requests: the programs dropped, one
   eager and one graphed query (the capture; its extra time over a replay
   is the capture's cost), then eager and graphed queries in turns under
   shared mask seeds, bit for bit equal and exact by the path's oracle (a
   control must fail), the launches of a replayed and of an eager query
   (equal), one graphed query profiled, each program's replay timed alone,
   ``torch.cuda.memory_reserved()`` after the drop, after an eager query,
   after the capture and after ``strip`` drops the programs; then the
   ``programs_summary`` line;
16. the ``kernels`` summary line (K1-K3, K9, K10, then G1-G5 with their
   launches on the in-process paths, then M1 with its launches on the
   ``CsRng`` path), then ``{"ok": true, "device": ...}``.
With ``--profile``, one warm query of phases 5, 6, 7 and 14 runs under
``torch.profiler`` (``profile_query``: device time by kernel and by the
port function around each launch, each port span's host time, busy and
idle share).

Any mismatch, build failure or launch failure raises, and the run exits
non-zero without the ``ok`` line.  Exits non-zero at once when
``torch.cuda.is_available()`` is false or the package is not beside it.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import importlib.util
import json
import logging
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


def _yardstick():
    """The benchmark's table of peaks and K2's and K3's work
    (``benchmark/harness/yardstick.py``), loaded by its path so that no
    module named ``harness`` goes on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(
        "yardstick", ROOT / "benchmark" / "harness" / "yardstick.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


yardstick = _yardstick()
# every value is an integer residue, so a kernel must equal its plain version
TOLERANCE = 0
# the PS path: caches per bundle of the dense DB, and warm queries
CACHES = 6
WARM = 3
# the non-PS path: receiver items, sender items and how many of those the
# receiver holds
DB_ITEMS = 1 << 20
QUERY_ITEMS = 2048
COMMON_ITEMS = 1024
# the two-process CLI: each process's time limit (seconds) and device
CLI_TIMEOUT = 420
CLI_DEVICE = "cuda"
# the DB lifecycle: its location seed, the items inserted and removed, how
# many inserted ones land on the fullest slot (enough to grow the cache
# axis), and the inserted and removed items in its query
LOC_SEED = b"chip-smoke-loc"
CHANGED_ITEMS = 1 << 14
GROW_ITEMS = 128
QUERY_CHANGED = 64
# labeled mode: its set (the largest non-PS set whose labels decrypt exactly
# in both packages), the query's items and those in the DB, and one label in
# ENCRYPT_EVERY encrypted under a public nonce
LABELED_SET = "1M-1-32"
LABELED_QUERY = 1536
LABELED_COMMON = 1024
ENCRYPT_EVERY = 64
LABEL_NONCE = bytes(range(16))
# the sharded receiver: the shards of its two meshes on the one card (1: the
# one-card deployment; 5: 16M-4096's 24 rows as 5/5/5/5/4, 1M-2048-cmp's 75 as
# 15 each, a check of the partition); the worker grid: its workers and the
# cache ranges a bundle range is split into
SHARDS = (1, 5)
GRID_WORKERS = 4
GRID_CACHE_PARTS = 2
# the 256-item sender of APSI's 1M-256 sets against the 2^20-item DB: its set
# (non-PS, K=512: K3 at 520 planes), its items and those in the DB
SMALL_QUERY_SET = "1M-256-288"
SMALL_QUERY = 256
SMALL_COMMON = 128
# the card's name and power limit (nvidia-smi), named beside every time
GPU = ""
# M1, the mask draw (ops/ctr_mod.py): each cell's mask shape and plain
# modulus t, drawn as the mask's (0, t) and as the labeled path's rho
# (1, t - 1), from counters whose blocks carry across 2^32 and 2^64, at
# byte offsets 0, 8 and 3 into the first block
MASK_SHAPES = {"16M-4096": ((4, 6, 8192), 2277377), "1M-2048-cmp": ((5, 15, 4096), 40961)}
MASK_STARTS = ((0, 0), ((1 << 32) - 5, 8), ((1 << 64) - 5, 3))
# H100 SXM shared memory: 32 banks of 4 bytes a clock on each of 132 SMs;
# its host link, PCIe Gen5 x16, in one direction
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
PCIE_BYTES_PER_S = 64e9
# csrc/ctr_mod.cu: threads a block (each makes one AES block, two words, a
# step), its grid's bound, its table's words (Te0 once for each bank) and
# AES-256's table lookups a block (14 rounds of 16)
M1_THREADS, M1_MAX_GRID, M1_TABLE, M1_LOOKUPS = 256, 1024, 256 * 32, 14 * 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rand_residues(shape, primes, gen):
    """Canonical int32 residues [..., L, N] of the given limb primes."""
    p = torch.tensor(primes, dtype=torch.int64, device="cuda").reshape(-1, 1)
    x = torch.randint(0, 1 << 30, shape, dtype=torch.int64, device="cuda", generator=gen)
    return (x % p).to(torch.int32)


def max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def bound_ms(nbytes, mults):
    """Least time at the published peaks (the yardstick's ``bound_s``), and
    which of its terms sets it: the bytes at the HBM rate or the 32-bit
    multiplies at the INT32 rate."""
    by_bytes = nbytes / yardstick.HBM_BYTES_PER_S >= mults / yardstick.INT32_OPS_PER_S
    return yardstick.bound_s(nbytes, mults) * 1e3, "bytes" if by_bytes else "operations"


def ceiling_ms(work, ceilings, product):
    """Least time at the card's measured ceilings (phase 3): the bytes of
    ``work`` at the measured stream rate or its products at the measured rate
    of ``product`` (a ``vpu_loop`` arm), the larger, and which it is."""
    nbytes, products, _ = work
    t_b = nbytes / ceilings["stream_bytes_per_s"] * 1e3
    t_o = products / ceilings["products_per_s"][product] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def ntt_work(shape, L, n, inverse):
    """Bytes, Shoup products and 32-bit multiplies of one transform: each
    residue read and written once plus the twiddle tables; one product a
    butterfly (the inverse adds its N^-1 scaling), 3 multiplies each."""
    rows = 1
    for d in shape[:-1]:
        rows *= d
    logn = n.bit_length() - 1
    nbytes = 2 * rows * n * 4 + 2 * L * n * 4
    products = rows * (n // 2) * logn + (rows * n if inverse else 0)
    return nbytes, products, 3 * products


def ntt_bound_ms(shape, L, n, inverse):
    return bound_ms(*ntt_work(shape, L, n, inverse)[::2])


def m1_thread_ops(lib) -> int:
    """M1's integer instructions, each counted once (its static SASS, less
    loads, stores, control and the uniform datapath's): a floor on what one
    thread runs in a step, one AES block and two words."""
    f = sass_functions(lib, "ctr_mod_kernel")[0]
    ops = re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", f, re.M)
    skip = ("LD", "ST", "BRA", "EXIT", "BAR", "S2R", "CS2R", "NOP", "BSSY", "BSYNC", "RET", "U")
    return sum(not o.startswith(skip) for o in ops)


def m1_work(n, offset, thread_ops):
    """Bytes, integer operations and shared-memory words of one M1 call of
    ``n`` words at byte ``offset``: a step of a block makes 256 AES blocks
    (one more at an offset) and 512 words, each block of the grid fills the
    table once, a block's keystream is stored as 4 words and each word reads
    3; the words are written and Te0 read once a block."""
    steps = -(-n // (2 * M1_THREADS))
    grid = min(steps, M1_MAX_GRID)
    blocks = steps * (M1_THREADS + (1 if offset else 0))
    nbytes = 4 * n + 4 * 256 * grid
    smem = blocks * (M1_LOOKUPS + 4) + 3 * n + grid * M1_TABLE
    return nbytes, steps * M1_THREADS * thread_ops, smem


def m1_bound_ms(work):
    """Least time of ``m1_work``'s call: its bytes at the HBM rate, its
    integer operations at the INT32 rate or its shared-memory words at the
    banks' rate, the largest, and which it is."""
    nbytes, ops, smem = work
    t = {"bytes": nbytes / yardstick.HBM_BYTES_PER_S * 1e3,
         "operations": ops / yardstick.INT32_OPS_PER_S * 1e3,
         "shared memory": smem / SMEM_WORDS_PER_S * 1e3}
    by = max(t, key=t.get)
    return t[by], by


def check_ctr_mod(seed) -> dict:
    """M1 against its plain version, bit for bit, at each cell's mask shape,
    for the mask's (0, t) and rho's (1, t - 1), from each of ``MASK_STARTS``
    under one key, and its kept draw's host copy too; each shape timed
    graph-replayed and eager beside its bound, the kept draw (the kernel
    also storing each word into pinned host memory, as ``Receiver._prepare``
    draws the mask) eager beside that bound and the host link's, and the
    host's cost of one kept draw."""
    from apsu_tpu_torch.ops import _build, ctr_mod
    from apsu_tpu_torch.tools import cuda_ms, graph_ms

    key = seed.to_bytes(8, "little", signed=True) + bytes(range(24))
    ks = ctr_mod.KeyStream(key, "cuda")
    thread_ops = m1_thread_ops(_build.build())
    cases, err = [], 0
    for cell, (shape, t) in MASK_SHAPES.items():
        n = int(np.prod(shape))
        for counter, offset in MASK_STARTS:
            for lo, span in ((0, t), (1, t - 1)):
                words, host = ks.draw(counter, offset, lo, span, shape, keep=True)
                ks.done.synchronize()
                got = words.cpu().numpy().ravel()
                want = ctr_mod.ctr_mod_plain(key, counter, offset, lo, span, n)
                e = int(np.abs(got.astype(np.int64) - want).max())
                if e > TOLERANCE or not (np.array_equal(got, want)
                                         and np.array_equal(host.ravel().view(np.int32), want)):
                    raise AssertionError(f"M1 != plain ({cell}, counter {counter}, offset "
                                         f"{offset}, ({lo}, {span})): {e}")
                err = max(err, e)
        counter, offset = MASK_STARTS[1]
        work = m1_work(n, offset, thread_ops)
        b_ms, b_by = m1_bound_ms(work)
        torch.cuda.synchronize()
        t0, reps = time.perf_counter(), 200
        for _ in range(reps):
            ks.draw(counter, offset, 0, t, shape, keep=True)
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        cases.append({
            "cell": cell, "shape": list(shape), "t": t, "offset": offset,
            "ms": graph_ms(lambda: ks.draw(counter, offset, 0, t, shape)),
            "eager_ms": cuda_ms(lambda: ks.draw(counter, offset, 0, t, shape), reps=20),
            "kept_eager_ms": cuda_ms(lambda: ks.draw(counter, offset, 0, t, shape, keep=True),
                                     reps=20),
            "kept_bound_ms": max(b_ms, 4 * n / PCIE_BYTES_PER_S * 1e3),
            "plain_ms": cuda_ms(lambda: ctr_mod.ctr_mod_plain(key, counter, offset, 0, t, n),
                                reps=2),
            "bound_ms": b_ms, "bound_by": b_by, "work": list(work),
            "host_us_kept_draw": host_us})
    out = {"check": "ctr_mod", "max_abs_err": err, "tolerance": TOLERANCE,
           "thread_ops": thread_ops, "cases": cases, "gpu": GPU}
    emit(out)
    return out


def csrng_path(params, db, req, oracle, seed) -> dict:
    """M1 on the PS path: a ``CsRng`` receiver on phase 4's DB runs the
    query WARM + 1 times with M1's launch count set to 0 before them; each
    query's mask is one launch (``prepare.mask.device`` counts it), equals
    the host draw of the same stream and passes the planted-match oracle."""
    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.mpc.prg import CsRng
    from apsu_tpu_torch.utils.stopwatch import GLOBAL

    key = seed.to_bytes(8, "little", signed=True) + b"chip-smoke mask key 24 b"
    recv, host = Receiver(params, db, rng=CsRng(key)), CsRng(key)
    t = params.seal_params.plain_modulus
    queries = WARM + 1
    drawn = GLOBAL.counts().get("prepare.mask.device", 0)
    reset_launches()
    oracles, same = [], []
    for _ in range(queries):
        resp = recv.run_query(req)
        mask = recv.last_mask
        want = host.integers(0, t, size=mask.shape, dtype=np.uint64).astype(np.uint32)
        same.append(bool(np.array_equal(mask, want)))
        oracles.append(list(oracle(resp, mask)))
    out = {"csrng_path": "16M-4096", "queries": queries,
           "launches": launch_counts()["ctr_mod"],
           "mask_device_count": GLOBAL.counts().get("prepare.mask.device", 0) - drawn,
           "masks_equal_host_draw": same, "oracle_per_query": oracles}
    emit(out)
    if not all(same):
        raise AssertionError("a card-drawn mask differs from the host draw of its stream")
    if any(wrong or false or matched == 0 for matched, wrong, false in oracles):
        raise AssertionError("planted-match oracle failed on a card-drawn mask")
    if out["launches"] != queries or out["mask_device_count"] != queries:
        raise AssertionError(f"M1 launched {out['launches']} times and counted "
                             f"{out['mask_device_count']} masks for {queries} queries")
    return out


def check_ntt(tb, shape, gen, label):
    from apsu_tpu_torch.ops import ntt as ntt_op
    from apsu_tpu_torch.tools import cuda_ms, graph_ms

    x = rand_residues(shape, tb.primes, gen)
    out = {}
    for inverse in (False, True):
        k = ntt_op.ntt_cuda(x, tb, inverse)
        pl = ntt_op.ntt_plain(x, tb, inverse)
        err = max_abs_err(k, pl)
        if err > TOLERANCE or not torch.equal(k, pl):
            raise AssertionError(f"NTT kernel != plain ({label}, inverse={inverse}): {err}")
        out["inverse" if inverse else "forward"] = {
            "max_abs_err": err, "tolerance": TOLERANCE,
            "ms": graph_ms(lambda: ntt_op.ntt_cuda(x, tb, inverse)),
            "plain_ms": cuda_ms(lambda: ntt_op.ntt_plain(x, tb, inverse), reps=2),
        }
    # round trip through the kernel alone
    if not torch.equal(ntt_op.ntt_cuda(ntt_op.ntt_cuda(x, tb), tb, True), x):
        raise AssertionError(f"NTT kernel round trip not exact ({label})")
    emit({"check": "ntt", "base": label, "shape": list(shape),
          "primes_bits": [p.bit_length() for p in tb.primes], **out})


def ps_plan(cache5, C) -> dict:
    """The launch shape K2 takes for ``cache5`` (``apsu_ps_inner_plan``)."""
    import ctypes

    from apsu_tpu_torch.ops import _build

    shape = (ctypes.c_int * 6)()
    R, nseg, ph, L, N = cache5.shape
    _build.check(_build.lib().apsu_ps_inner_plan(R, C, nseg, ph, L, N, shape), "ps_inner plan")
    return dict(zip(("lanes_a_block", "rows_a_block", "row_chunks", "blocks_an_sm", "smem_bytes",
                     "low_chunked"), shape))


def check_ps_inner(low, cache5, q, label):
    from apsu_tpu_torch.ops import polyeval
    from apsu_tpu_torch.tools import cuda_ms, graph_ms

    C = cache5.shape[0] // low.shape[0]
    k = polyeval.ps_inner_cuda(low, cache5, q, C)
    pl = polyeval.ps_inner_plain(low, cache5, q, C)
    err = max_abs_err(k, pl)
    if err > TOLERANCE or not torch.equal(k, pl):
        raise AssertionError(f"PS inner kernel != plain ({label}): {err}")
    b_ms, b_by = bound_ms(*yardstick.ps_work(tuple(low.shape), tuple(cache5.shape)))
    res = {
        "check": "ps_inner", "case": label, "low": list(low.shape), "cache5": list(cache5.shape),
        "cache5_row_stride": cache5.stride(0), "primes_bits": [p.bit_length() for p in q.primes],
        "max_abs_err": err, "tolerance": TOLERANCE,
        "ms": graph_ms(lambda: polyeval.ps_inner_cuda(low, cache5, q, C)),
        "plain_ms": cuda_ms(lambda: polyeval.ps_inner_plain(low, cache5, q, C), reps=1),
        "bound_ms": b_ms, "bound_by": b_by, "plan": ps_plan(cache5, C),
    }
    emit(res)
    return res


def check_eval_dot(powers, cache, base, label):
    from apsu_tpu_torch.ops import polyeval
    from apsu_tpu_torch.tools import cuda_ms, graph_ms

    k = polyeval.eval_dot_cuda(powers, cache, base)
    pl = polyeval.eval_dot_plain(powers, cache, base)
    err = max_abs_err(k, pl)
    if err > TOLERANCE or not torch.equal(k, pl):
        raise AssertionError(f"dot-product kernel != plain ({label}): {err}")
    b_ms, b_by = bound_ms(*yardstick.dot_work(tuple(powers.shape), tuple(cache.shape)))
    res = {
        "check": "eval_dot", "case": label, "powers": list(powers.shape),
        "cache": list(cache.shape), "primes_bits": [p.bit_length() for p in base.primes],
        "max_abs_err": err, "tolerance": TOLERANCE,
        "ms": graph_ms(lambda: polyeval.eval_dot_cuda(powers, cache, base)),
        "plain_ms": cuda_ms(lambda: polyeval.eval_dot_plain(powers, cache, base), reps=2),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(res)
    return res


def check_ntt_shapes(shapes, gen):
    """NTT kernel against its plain version at every recorded (shape,
    inverse, tables) launch; returns a summary with the per-query device
    time (each shape replayed from a CUDA graph) and bound, summed over the
    launches, and the largest shape's kernel, plain and bound times."""
    from apsu_tpu_torch.ops import ntt as ntt_op
    from apsu_tpu_torch.tools import cuda_ms, graph_ms

    distinct = {}
    for shape, inverse, tb in shapes:
        key = (shape, inverse, id(tb))
        distinct.setdefault(key, [shape, inverse, tb, 0])[3] += 1
    query_ms, query_bound_ms, big, err, works = 0.0, 0.0, None, 0, []
    for shape, inverse, tb, count in distinct.values():
        x = rand_residues(shape, tb.primes, gen)
        k = ntt_op.ntt_cuda(x, tb, inverse)
        pl = ntt_op.ntt_plain(x, tb, inverse)
        err = max(err, max_abs_err(k, pl))
        if not torch.equal(k, pl):
            raise AssertionError(f"NTT kernel != plain at {shape} inverse={inverse}")
        ms = graph_ms(lambda: ntt_op.ntt_cuda(x, tb, inverse))
        query_ms += ms * count
        query_bound_ms += ntt_bound_ms(shape, tb.L, tb.n, inverse)[0] * count
        works.append([*ntt_work(shape, tb.L, tb.n, inverse), count])
        if big is None or x.numel() > big[0].numel():
            big = (x, tb, inverse, ms)
        del x, k, pl
    x, tb, inverse, ms = big
    plain_ms = cuda_ms(lambda: ntt_op.ntt_plain(x, tb, inverse), reps=2)
    b_ms, b_by = ntt_bound_ms(tuple(x.shape), tb.L, tb.n, inverse)
    summary = {"launches": len(shapes), "distinct_shapes": len(distinct),
               "device_ms_per_query": query_ms, "bound_ms_per_query": query_bound_ms,
               "max_abs_err": err,
               "largest_shape": list(x.shape), "largest_inverse": inverse,
               "largest_ms": ms, "largest_plain_ms": plain_ms, "largest_bound_ms": b_ms,
               "largest_bound_by": b_by, "n": sorted({s[-1] for s, _, _ in shapes}),
               "work_by_shape": works}
    return summary


@contextlib.contextmanager
def recording_kernels(calls: dict, on: bool = True, keep: bool = True):
    """While active (and ``on``), each call of a kernel's CUDA wrapper also
    appends its arguments to ``calls``: "ntt" gets (shape, inverse, tables),
    "eval_dot" (powers shape, cache, base), "ps_inner" (low shape, cache5,
    base) and, with ``keep``, "glue" (wrapper name, its arguments with each
    tensor copied with its own strides, ``strided_copy``) for G1-G5.  With
    ``keep`` False a call holds no tensor and no tables, only what describes
    them: the cache's (shape, strides) and the tables' or base's (primes,
    N), so a whole process is recorded without keeping its device memory
    alive (``cli_child``).  The counts of launches are the wrappers' own.

    A call made while a program is captured into a CUDA graph
    (``engine/programs.py``) launches nothing and is not recorded: its
    shapes are those of the program's eager warm-up call, which is.  Each
    replay of a program adds its launches to "replayed" (counter name ->
    launches), so recorded calls + replayed launches = launches."""
    from apsu_tpu_torch.engine import programs
    from apsu_tpu_torch.ops import behz
    from apsu_tpu_torch.ops import ntt as ntt_op
    from apsu_tpu_torch.ops import polyeval

    names = [name for _, _, name, _ in counters()]
    real_ntt, real_dot, real_ps = ntt_op.ntt_cuda, polyeval.eval_dot_cuda, polyeval.ps_inner_cuda
    real_glue = {name: getattr(behz, name) for name in GLUE_WRAPPERS}
    real_replay = programs.Program.replay
    held = (lambda t: t) if keep else (lambda t: (tuple(t.shape), tuple(t.stride())))
    tables = (lambda tb: tb) if keep else (lambda tb: (tuple(tb.primes), tb.n))
    capturing = torch.cuda.is_current_stream_capturing

    def ntt(x, tb, inverse=False):
        if not capturing():
            calls["ntt"].append((tuple(x.shape), inverse, tables(tb)))
        return real_ntt(x, tb, inverse)

    def dot(powers, cache, base):
        if not capturing():
            calls["eval_dot"].append((tuple(powers.shape), held(cache), tables(base)))
        return real_dot(powers, cache, base)

    def ps(low, cache5, base, caches_per_bundle):
        if not capturing():
            calls["ps_inner"].append((tuple(low.shape), held(cache5), tables(base)))
        return real_ps(low, cache5, base, caches_per_bundle)

    def glue(name):
        def run(*args):
            if not capturing():
                calls["glue"].append((name, [strided_copy(a) if isinstance(a, torch.Tensor)
                                             else a for a in args]))
            return real_glue[name](*args)
        return run

    def replay(prog):
        real_replay(prog)
        for name, n in zip(names, prog.per_call):
            calls["replayed"][name] = calls["replayed"].get(name, 0) + n

    if on:
        ntt_op.ntt_cuda, polyeval.eval_dot_cuda, polyeval.ps_inner_cuda = ntt, dot, ps
        programs.Program.replay = replay
        if keep:
            for name in GLUE_WRAPPERS:
                setattr(behz, name, glue(name))
    try:
        yield calls
    finally:
        ntt_op.ntt_cuda, polyeval.eval_dot_cuda, polyeval.ps_inner_cuda = real_ntt, real_dot, real_ps
        programs.Program.replay = real_replay
        for name, f in real_glue.items():
            setattr(behz, name, f)


def strided_copy(t):
    """A copy of ``t`` with its shape and strides (the storage it spans is
    copied whole), so a call replayed on it reads the layout the path
    passed: a view such as a slice of a middle axis stays a view."""
    if t.numel() == 0:
        return t.clone()
    span = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride()))
    buf = torch.empty(span, dtype=t.dtype, device=t.device)
    buf.copy_(t.as_strided((span,), (1,), t.storage_offset()))
    return buf.as_strided(t.shape, t.stride())


def kernel_calls() -> dict:
    return {"ntt": [], "eval_dot": [], "ps_inner": [], "glue": [], "replayed": {}}


def recorded_launches(recs: list) -> dict:
    """The launches that ``recording_kernels`` saw in ``recs`` (one
    ``kernel_calls`` dict a process): its recorded calls plus what its
    program replays launched, by kernel."""
    return {k: sum(len(rec[k]) + rec["replayed"].get(k, 0) for rec in recs)
            for k in ("ntt", "ps_inner", "eval_dot")}


def counters() -> list:
    """Each launch counter of ``ops/counts.COUNTERS``, in its order, as
    (module, counter, name, kernel): ``kernel`` the first ``__global__``
    function of its pattern (which gives the name's length, then the name),
    ``name`` that less ``_kernel`` as the ``kernels`` and ``glue_check``
    lines print it, with ``_general`` for a general build's counter."""
    from apsu_tpu_torch.ops import counts

    out = []
    for mod, counter, pattern in counts.COUNTERS:
        digits = re.match(r"\d+", pattern)[0]
        kernel = pattern[len(digits): len(digits) + int(digits)]
        name = kernel.removesuffix("_kernel") + ("_general" if "general" in counter else "")
        out.append((mod, counter, name, kernel))
    return out


def launch_counts() -> dict:
    """Every counter's launches since it was last reset, by ``counters``' name."""
    return {name: getattr(mod, counter) for mod, counter, name, _ in counters()}


def reset_launches() -> None:
    """Every counter of ``ops/counts.COUNTERS`` set to 0."""
    for mod, counter, *_ in counters():
        setattr(mod, counter, 0)


def query_runs(recv, req, calls, timings=None):
    """``recv.run_query(req)``, each ended by a device sync and timed: once
    cold (its programs built and captured), WARM times warm (replayed), once
    under ``programs.eager()`` with every kernel call recorded into
    ``calls``, and, with ``timings`` a dict, once more replayed with the
    in-call split into it.  The launch counts start from 0.  Returns
    (runs, launches, launches_per_query): each run (response, mask,
    seconds, how), how one of "cold", "graph", "eager"; the launches of
    all the runs; the launches of one replayed query."""
    from apsu_tpu_torch.engine import programs

    runs = []

    def run(how, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = recv.run_query(req, **kw)
        torch.cuda.synchronize()
        runs.append((resp, recv.last_mask, time.perf_counter() - t0, how))

    reset_launches()
    run("cold")
    after_cold = launch_counts()
    for _ in range(WARM):
        run("graph")
    per_query = {k: (v - after_cold[k]) / WARM for k, v in launch_counts().items()}
    with recording_kernels(calls), programs.eager():
        run("eager")
    if timings is not None:
        run("graph", timings=timings)
    return runs, launch_counts(), per_query


# the glue kernels: (name in the kernels line, as ``counters`` names its
# launch counter, source, the reference's code it stands for, its CUDA wrappers)
GLUE_KERNELS = (
    ("behz_lift", "apsu_tpu_torch/csrc/behz_lift.cu",
     "apsu_tpu/core/bfv.py:753, :909-912; apsu_tpu/core/rns.py:165 (jitted XLA, no Pallas)",
     ("scale_cuda", "lift_cuda", "digits_cuda")),
    ("mont_mac", "apsu_tpu_torch/csrc/mont_mac.cu",
     "apsu_tpu/core/bfv.py:63, :776-785, :914-922 (jitted XLA, no Pallas)",
     ("mont_mac_cuda", "keyswitch_mac_cuda")),
    ("behz_scaledown", "apsu_tpu_torch/csrc/behz_scaledown.cu",
     "apsu_tpu/core/bfv.py:787-793; apsu_tpu/core/rns.py:129, :245 (jitted XLA, no Pallas)",
     ("scaledown_cuda",)),
    ("rns_divround", "apsu_tpu_torch/csrc/rns_divround.cu",
     "apsu_tpu/core/bfv.py:923-926, :931-945; apsu_tpu/core/rns.py:295 (jitted XLA, no Pallas)",
     ("keyswitch_div_cuda", "mod_switch_cuda")),
    ("scale_add", "apsu_tpu_torch/csrc/scale_add.cu",
     "apsu_tpu/core/bfv.py:646; apsu_tpu/engine/evaluator.py:941-972 (jitted XLA, no Pallas)",
     ("delta_cuda", "delta_add_cuda", "add_into_cuda")),
)
GLUE_NAMES = tuple(name for name, *_ in GLUE_KERNELS)
GLUE_WRAPPERS = tuple(w for *_, ws in GLUE_KERNELS for w in ws)
# the registers and spilled bytes of each build of G3 and the lift, from the
# package build's ptxas report (phase 1, ``glue_builds``)
GLUE_BUILDS: dict = {}


def glue_builds(log: str) -> dict:
    """The registers and spilled bytes of each build of G3 and G1's lift in a
    ``-Xptxas -v`` log: {kernel: {"LqxLb" or "general": {...}}}."""
    out = {}
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"(behz_scaledown_kernel|behz_lift_kernel)ILi(\d+)ELi(\d+)ELb([01])E",
                      chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        if not m or not regs:
            continue
        name = m.group(1)[: -len("_kernel")]
        build = f"{m.group(2)}x{m.group(3)}" if m.group(4) == "1" else "general"
        out.setdefault(name, {})[build] = {
            "registers": int(regs.group(1)),
            "spill_bytes": sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", chunk))}
    return out


def glue_build_of(wrapper, args):
    """(kernel, build) of a G3 or lift call, as ``glue_builds`` names it, or
    None for another call."""
    from apsu_tpu_torch.ops import behz

    if wrapper == "scaledown_cuda":
        pair, name = (args[2].q.k, args[2].bsk.k), "behz_scaledown"
    elif wrapper == "lift_cuda":
        pair, name = (args[1].src.k, args[1].dst.k), "behz_lift"
    else:
        return None
    return name, (f"{pair[0]}x{pair[1]}" if pair in behz.exact_pairs() else "general")


def glue_work(name, args, out):
    """Bytes (each input read once, each output written once), products and
    32-bit multiplies of one glue call, as the kernels now compute it: a
    Shoup product is 3 multiplies (as ``ntt_work`` counts), a Montgomery
    product 4, a widening 32x32->64 product 2 (IMAD.WIDE.U32 runs at half
    IMAD's rate, PERF.md section 6), a reduce64 of a lazy sum 5 (a Shoup
    product and a product by 1, whose low multiply is free); G3's and the
    lift's sums are counted term by term (csrc/behz_scaledown.cu,
    behz_lift.cu).  A count left at the first design's arithmetic would
    overstate the least time and could read above 100%.  The products are
    the multiplies over 3, as Shoup products for ``shoup_lazy``'s measured
    rate (``ceiling_ms``)."""
    nbytes, mults = _glue_bytes_mults(name, args, out)
    return nbytes, mults / 3, mults


def _glue_bytes_mults(name, args, out):
    outs = [o for o in (out if isinstance(out, tuple) else (out,)) if o is not None]
    out_elems = sum(o.numel() for o in outs)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    in_elems = sum(t.numel() for t in tensors)
    if name == "scale_cuda" or name == "digits_cuda":
        shoups = out_elems
    elif name == "lift_cuda":
        # the q form and c_i (Shoup), r's 16-bit sum (lq + 1 multiplies),
        # then Lb sums of Lq + 1 widening products and a reduce64 each
        x, conv, want_q = args
        lq, lb = conv.src.k, conv.dst.k
        per = 3 * lq * (2 if want_q else 1) + lq + 1 + 2 * lb * (lq + 1) + 5 * lb
        return 4 * (in_elems + out_elems), x.numel() // lq * per
    elif name == "mont_mac_cuda":
        fa, fb, _ = args
        return 4 * (in_elems + out_elems), out_elems // 3 * 4 * max(fa.shape[-4],
                                                                    fb.shape[-4]) * 4
    elif name == "keyswitch_mac_cuda":
        d, _, qp, lvl, _ = args
        key = lvl * 2 * qp.k * qp.n
        return 4 * (d.numel() + key + out_elems), out_elems // 2 * 2 * lvl * 4
    elif name == "scaledown_cuda":
        # y_i (Shoup); Lb sums of Lq + 1 widening products and alpha's of Lb,
        # Lq sums of Lb, each reduced once (reduce64)
        sd = args[2]
        lq, lb = sd.q.k, sd.bsk.k
        per = 3 * lq + 2 * lb * (lq + 1) + 2 * lb + 2 * lq * lb + 5 * (lb + 1 + lq)
        return 4 * (in_elems + out_elems), out_elems // lq * per
    elif name in ("delta_cuda", "delta_add_cuda"):
        # r*m mod t, then a Shoup product a limb (and one more for each
        # Montgomery output); x read and written in place
        m = args[1] if name == "delta_add_cuda" else args[0]
        shoups = m.numel() + sum(o.numel() for o in outs)
    elif name == "add_into_cuda":
        shoups = 0
    elif name == "keyswitch_div_cuda":
        u, data, _, div = args
        k = div.q.k
        in_elems = u.numel() + 2 * data.numel() // data.shape[-3]
        shoups = out_elems // k * (k + 1 + 2 * k)
    else:   # mod_switch_cuda
        _, _, top, target = args
        shoups = out_elems // target * 2 * sum(range(target, top))
    return 4 * (in_elems + out_elems), 3 * shoups


def check_glue_calls(calls, label, ceilings) -> dict:
    """G1-G5 against their plain versions at every call recorded in
    ``calls`` (one query's, each on the inputs it was given), then each
    distinct call (wrapper, shapes, strides, tables) timed by graph replay:
    for each kernel its launches, per-query device time, bound and ceiling
    (its bytes at phase 3's measured stream or its products at
    ``shoup_lazy``'s measured rate, the larger; ``ceilings``) summed over the
    calls and by wrapper, and its largest call's time, plain time, bound and
    ceiling; G3's and the lift's builds with their registers and spills.
    The general builds' launches since the path's counters were reset (no
    protocol path takes them) are read first and must be 0."""
    from apsu_tpu_torch.ops import behz
    from apsu_tpu_torch.tools import cuda_ms, graph_ms

    general = {name.removesuffix("_general"): n for name, n in launch_counts().items()
               if name.endswith("_general")}
    if any(general.values()):
        raise AssertionError(f"a general build launched ({label}): {general}")
    by_kernel = {name: {"launches": 0, "max_abs_err": 0, "device_ms_per_query": 0.0,
                        "bound_ms_per_query": 0.0, "ceiling_ms_per_query": 0.0,
                        "by_wrapper": {}, "ms_by_wrapper": {}, "builds": {},
                        "general_launches": general.get(name, 0), "distinct": {}}
                 for name in GLUE_NAMES}
    kernel_of = {w: name for name, *_, ws in GLUE_KERNELS for w in ws}
    def fresh(args):   # G5 writes into its first operand: each run gets its own
        return [strided_copy(a) if isinstance(a, torch.Tensor) else a for a in args]

    for wrapper, args in calls:
        got = getattr(behz, wrapper)(*fresh(args))
        want = getattr(behz, wrapper.replace("_cuda", "_plain"))(*fresh(args))
        k = by_kernel[kernel_of[wrapper]]
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if (g is None) != (w is None) or (g is not None and not torch.equal(g, w)):
                raise AssertionError(f"{wrapper} kernel != plain ({label})")
            if g is not None:
                k["max_abs_err"] = max(k["max_abs_err"], max_abs_err(g, w))
        k["launches"] += 1
        k["by_wrapper"][wrapper] = k["by_wrapper"].get(wrapper, 0) + 1
        build = glue_build_of(wrapper, args)
        if build is not None:
            k["builds"][build[1]] = GLUE_BUILDS.get(build[0], {}).get(build[1])
        key = (wrapper,) + tuple((tuple(a.shape), tuple(a.stride())) if isinstance(a, torch.Tensor)
                                 else id(a) for a in args)
        k["distinct"].setdefault(key, [wrapper, args, got, 0])[3] += 1
    out = {}
    for name, k in by_kernel.items():
        big = None
        for wrapper, args, got, count in k.pop("distinct").values():
            fn = getattr(behz, wrapper)
            ms = graph_ms(lambda: fn(*args))
            work = glue_work(wrapper, args, got)
            nbytes, _, mults = work
            b_ms, c_ms = bound_ms(nbytes, mults)[0], ceiling_ms(work, ceilings, "shoup_lazy")[0]
            k["device_ms_per_query"] += ms * count
            k["bound_ms_per_query"] += b_ms * count
            k["ceiling_ms_per_query"] += c_ms * count
            sums = k["ms_by_wrapper"].setdefault(wrapper, {"device_ms": 0.0, "bound_ms": 0.0,
                                                           "ceiling_ms": 0.0})
            for key, v in (("device_ms", ms), ("bound_ms", b_ms), ("ceiling_ms", c_ms)):
                sums[key] += v * count
            if big is None or nbytes > big[3][0]:
                big = (wrapper, args, ms, work)
        if big is not None:
            wrapper, args, ms, work = big
            plain = getattr(behz, wrapper.replace("_cuda", "_plain"))
            b_ms, b_by = bound_ms(work[0], work[2])
            c_ms, c_by = ceiling_ms(work, ceilings, "shoup_lazy")
            k.update({"largest_wrapper": wrapper, "largest_ms": ms,
                      "largest_plain_ms": cuda_ms(lambda: plain(*args), reps=1),
                      "largest_bound_ms": b_ms, "largest_bound_by": b_by,
                      "largest_bytes": work[0], "largest_mults": work[2],
                      "largest_ceiling_ms": c_ms, "largest_ceiling_by": c_by,
                      "largest_shapes": [list(a.shape) for a in args
                                         if isinstance(a, torch.Tensor)]})
        out[name] = k
    emit({"glue_check": label, **out})
    return out


def cli_child(out: str, module: str, argv: list) -> int:
    """``python -m module *argv`` in this process, with every kernel call
    recorded (``recording_kernels`` without tensors); the calls are written
    to ``out`` as JSON for ``replay_calls``."""
    import runpy

    sys.path.insert(0, str(ROOT))
    calls = kernel_calls()
    sys.argv = [module, *argv]
    with recording_kernels(calls, keep=False):
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    Path(out).write_text(json.dumps(calls))
    return 0


def replay_calls(recs: list, gen, label: str) -> dict:
    """The NTT and PS inner-sum kernels against their plain versions at every
    call that ``cli_child`` recorded in ``recs`` (one dict a process; the CLI
    path launches no dot product, which ``cli_path`` checks): random residues
    of each recorded shape, each cache laid out with its recorded strides,
    the tables and bases rebuilt from the recorded primes."""
    from apsu_tpu_torch.core.rns import RnsBase

    bases = {}

    def base(primes, n):
        key = (tuple(primes), n)
        if key not in bases:
            bases[key] = RnsBase(list(primes), n, "cuda")
        return bases[key]

    def distinct(kind):
        return {json.dumps(c): c for rec in recs for c in rec[kind]}.values()

    ntt = [(tuple(s), inv, base(*pn).ntt) for rec in recs for s, inv, pn in rec["ntt"]]
    out = {"ntt": check_ntt_shapes(ntt, gen), "ps_inner": []}
    for low_shape, (shape, stride), pn in distinct("ps_inner"):
        q = base(*pn)
        R, nseg, ph, L, N = shape
        rows = rand_residues((R, stride[0] // (L * N), L, N), q.primes, gen)
        cache5 = rows[:, : nseg * ph].reshape(shape)
        if tuple(cache5.stride()) != tuple(stride):
            raise AssertionError(f"cannot lay out the recorded cache {shape} {stride}")
        low = rand_residues(tuple(low_shape), q.primes, gen)
        out["ps_inner"].append(check_ps_inner(low, cache5, q, f"{label} (recorded)"))
        del rows, cache5, low
    return out


def make_sets(rng, n_db, n_query, n_common):
    """Random 128-bit item sets with a planted intersection."""
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def as_set(a):
    return {(int(x), int(y)) for x, y in a}


# the port's functions that profile_query charges device time to: each
# kernel a PyTorch op launched goes to the innermost of these around the op
# ("rest" if none); the profiler links the hand-written kernels, launched
# through ctypes, to no op, so those are reported by name.  BfvContext
# methods, then module functions of the evaluator
PROFILE_METHODS = ("operand_forms", "tensor_scaledown_fused", "premul_sum_rhs",
                   "multiply_sum_fused", "relinearize", "mod_switch_to", "to_ntt", "from_ntt",
                   "_scale_impl", "encode", "decode")
PROFILE_FUNCTIONS = ("_ps_rows", "_run_schedule", "eval_matching_polys")
# the query's programs (a replay's kernels go to its stage) and the host's
# preparation of a query (validation, the mask drawn on the host, the upload)
PROFILE_PROGRAMS = ("power_tensor", "ps_power_tensors", "matching", "matching_labeled",
                    "ps_matching")


def traced_names() -> list:
    """The hand-written kernels by their ``__global__`` function (``counters``),
    each once: a kernel ``torch.profiler`` traced on the device is one whose
    demangled name holds it."""
    return list(dict.fromkeys(kernel for *_, kernel in counters()))


@contextlib.contextmanager
def profile_spans():
    """While active, each of ``PROFILE_METHODS``/``PROFILE_FUNCTIONS``/
    ``PROFILE_PROGRAMS`` and ``Receiver._prepare`` of the imported package
    runs inside ``record_function("apsu:<name>")``."""
    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.core.bfv import BfvContext
    from apsu_tpu_torch.engine import evaluator, programs

    def span(name, f):
        def run(*a, **k):
            with torch.profiler.record_function("apsu:" + name):
                return f(*a, **k)
        return run

    saved = [(BfvContext, n, getattr(BfvContext, n)) for n in PROFILE_METHODS]
    saved += [(evaluator, n, getattr(evaluator, n)) for n in PROFILE_FUNCTIONS]
    saved += [(programs, n, getattr(programs, n)) for n in PROFILE_PROGRAMS]
    saved.append((Receiver, "_prepare", Receiver._prepare))
    for owner, name, f in saved:
        setattr(owner, name, span(name, f))
    try:
        yield
    finally:
        for owner, name, f in saved:
            setattr(owner, name, f)


def device_ms_by_span(events) -> dict:
    """Device milliseconds and kernel count of every ``apsu:`` span (the
    innermost around each PyTorch op that launched kernels) in a profiler's
    ``events()``."""
    out = {}
    for e in events:
        if not e.kernels:
            continue
        a = e
        while a is not None and not a.name.startswith("apsu:"):
            a = a.cpu_parent
        key = a.name[5:] if a is not None else "rest"
        d = out.setdefault(key, {"device_ms": 0.0, "kernels": 0})
        d["device_ms"] += sum(k.duration for k in e.kernels) / 1e3
        d["kernels"] += len(e.kernels)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["device_ms"]))


def profile_query(recv, req) -> dict:
    """Device time by kernel name over one warm query (torch.profiler), the
    plain PyTorch ops' by the port function that ran them (``profile_spans``;
    a program's replayed kernels are linked to no span), each span's host
    time, and the device's busy share of the query's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile_spans(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        recv.run_query(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: each span shows on the device too, as an annotation
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.key.startswith("apsu:")]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    ours = {k: {"device_ms": sum(e.self_device_time_total for e in events if k in e.key) / 1e3,
                "count": sum(e.count for e in events if k in e.key)}
            for k in traced_names()}
    hand_ms = sum(v["device_ms"] for v in ours.values())
    res = {"profile_wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms, "hand_written_kernels": ours,
           "plain_device_ms": busy_ms - hand_ms, "kernels_launched": sum(e.count for e in events),
           "by_function": device_ms_by_span(prof.events()),
           "host_ms_by_span": {e.key[5:]: e.cpu_time_total / 1e3 for e in prof.key_averages()
                               if e.key.startswith("apsu:") and e.device_type != DeviceType.CUDA},
           "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                    "count": e.count} for e in top]}
    emit(res)
    return res


def ps_query(params, bfv, roots, rng, query_lvl):
    """A query against a DB that ``set_synthetic_dense`` built with ``roots``:
    the planted query vector, the secret key and the ``QueryRequest`` with
    its relinearization key at ``query_lvl``."""
    from apsu_tpu_torch.api.parties import QueryRequest, _pow_mod
    from apsu_tpu_torch.engine.probe import plant_query

    qp = params.query_params
    t = params.seal_params.plain_modulus
    qvec = plant_query(roots, rng, t)
    plist = tuple(qp.query_powers)
    stack = np.stack([_pow_mod(qvec.astype(np.uint64), s, t).astype(np.uint32) for s in plist])
    sk = bfv.gen_secret_key(rng)
    ct = bfv.encrypt_symmetric(bfv.encode(stack), sk, rng, level=query_lvl)
    rk = bfv.gen_relin_key(sk, rng, level=query_lvl)
    req = QueryRequest(power_list=plist, powers_data=ct.data, relin_key=rk.ksk)
    return qvec, sk, req


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm query with torch.profiler")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "apsu_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: apsu_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.core.bfv import Ciphertext
    from apsu_tpu_torch.core.mod32 import to_u32
    from apsu_tpu_torch.core.nt import gen_ntt_primes
    from apsu_tpu_torch.core.ntt import NttContext
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.db.measured_levels import query_level
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.ops import _build, polyeval

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global GPU
    GPU = smi
    import cryptography

    cxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    emit({"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "cryptography": cryptography.__version__,
          "g++": cxx.stdout.splitlines()[0]})

    t0 = time.perf_counter()
    _build.lib()
    emit({"build_s": time.perf_counter() - t0, "built_now": _build.build_seconds is not None,
          "build_dir": str(_build.build().parent.name),
          "ptxas": [ln.strip() for ln in _build.ptxas_log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    GLUE_BUILDS.update(glue_builds(_build.ptxas_log))
    emit({"glue_builds": GLUE_BUILDS})

    # -- phase 2: kernels against plain versions at the paths' shapes -------
    params = PSUParams.load_file(str(ROOT / "parameters" / "16M-4096.json"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    db = ReceiverDB(params, device="cuda")
    bfv = db.bfv
    ps_lvl, ql = db.ps_level(), query_level(params, len(bfv.q_primes))
    tp, qp = params.table_params, params.query_params
    K, N = tp.max_items_per_bin, params.poly_degree
    ph = qp.ps_low_degree + 1
    nh = K // ph
    eval_bsk = bfv._mul_ctx(ps_lvl, max(1, (nh - 1).bit_length()))["bsk"]
    bases = {
        f"eval q (L={ps_lvl})": bfv.levels[ps_lvl],
        f"query q (L={ql})": bfv.levels[ql],
        f"eval Bsk (L={eval_bsk.k})": eval_bsk,
        f"key qp (L={ql + 1})": bfv._qp_level(ql),
        "plain modulus t (L=1)": bfv.t_base,
    }
    for label, base in bases.items():
        check_ntt(base.ntt, (48, base.k, N), gen, label)
    check_ntt(NttContext(gen_ntt_primes([30], 2 * 4096), 4096, "cuda"), (48, 1, 4096), gen,
              "30-bit prime, N=4096")

    B, C = params.bundle_idx_count, CACHES
    planes = polyeval.plane_count(K, qp.ps_low_degree)
    nseg = planes // ph
    q = bfv.levels[ps_lvl]
    low = rand_residues((B, ph - 1, 2, q.k, N), q.primes, gen)
    cache = rand_residues((B * C, planes, q.k, N), q.primes, gen)
    cache5 = cache[:, : nseg * ph].reshape(B * C, nseg, ph, q.k, N)
    check_ps_inner(low, cache5, q, "16M-4096 eval shape, random cache")
    del low, cache, cache5
    dot_checks = check_dot_cases(gen)
    ps_checks = check_ps_wide_cases(gen)
    m1 = check_ctr_mod(args.seed)
    torch.cuda.empty_cache()

    # -- phase 3: the ceilings (K9, K10 and the two measuring tools) ---------
    ceil = ceilings_phase()
    torch.cuda.empty_cache()

    # -- phase 4: the PS path at full width ----------------------------------
    rng = np.random.default_rng(args.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roots = db.set_synthetic_dense(rng, n_caches=C)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    qvec, sk, req = ps_query(params, bfv, roots, rng, ql)
    recv = Receiver(params, db, rng=np.random.default_rng(args.seed + 1))
    lane_match = np.stack([(roots[b] == qvec[b][None, None, :]).any(axis=1) for b in range(B)])
    emit({"main_path": "16M-4096", "build_s": build_s, "cache_shape": list(db.coeff_cache.shape),
          "cache_gb": db.coeff_cache.numel() * 4 / 1e9, "eval_level": db.eval_lvl,
          "result_level": db.result_lvl, "query_level": ql,
          "planted_matches": int(lane_match.sum())})

    calls = kernel_calls()  # the kernel launches of the last warm query

    def oracle(resp, mask):
        res = Ciphertext(resp.results, is_ntt=False, level=resp.eval_level)
        vals = to_u32(bfv.decode(bfv.decrypt_device(res, sk)))
        eq = vals == mask
        matched = int(lane_match.sum())
        wrong = int((lane_match & ~eq).sum())
        false = int((~lane_match & eq).sum())
        return matched, wrong, false

    # one cold query (its programs captured), WARM replayed ones, one
    # recorded under eager() and one replayed with the in-call split; each
    # keeps its response and its mask
    timings = {}
    runs, launches, per_query = query_runs(recv, req, calls, timings)
    launches = {k: launches[k] for k in ("ntt", "ps_inner", *GLUE_NAMES)}
    oracles = [oracle(resp, mask) for resp, mask, *_ in runs]
    # control: the recorded response against the split query's mask
    control = oracle(runs[-2][0], runs[-1][1])
    warm = [s for _, _, s, how in runs[:-1] if how == "graph"]
    emit({"first_query_s": runs[0][2], "warm_query_s": warm, "warm_best_s": min(warm),
          "eager_recorded_query_s": runs[-2][2],
          "bundles_per_s": B * C / min(warm), "powers_s": timings["powers_s"],
          "eval_s": timings["eval_s"], "queries": [how for *_, how in runs],
          "oracle_per_query": [list(o) for o in oracles], "control_other_mask": list(control),
          "launches": launches, "launches_per_query": per_query,
          "result_shape": list(runs[-1][0].results.shape),
          "result_checksums": [int(r.results.to(torch.int64).sum()) for r, *_ in runs],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if any(wrong or false or matched == 0 for matched, wrong, false in oracles):
        raise AssertionError("planted-match oracle failed")
    if control[1] == 0:
        raise AssertionError("the oracle accepted a response checked against another mask")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    m1_path = csrng_path(params, db, req, oracle, args.seed)

    # -- phase 5: kernels at every shape the warm query used -----------------
    ntt_ps = check_ntt_shapes(calls["ntt"], gen)
    emit({"ntt_warm_query": ntt_ps})
    glue_ps = check_glue_calls(calls["glue"], "16M-4096 warm query", ceil["ceilings"])
    calls["glue"].clear()

    low = rand_residues((B, ph - 1, 2, q.k, N), q.primes, gen)
    cache5 = db.coeff_cache.reshape(B * C, planes, q.k, N)[:, : nseg * ph].reshape(
        B * C, nseg, ph, q.k, N)
    ps = check_ps_inner(low, cache5, q, "16M-4096 warm query (DB cache)")

    # -- phase 12, first set: the sharded receiver on phase 4's DB -----------
    def exact16(resp, mask):
        matched, wrong, false = oracle(resp, mask)
        return matched > 0 and wrong == 0 and false == 0

    t0 = time.perf_counter()
    shard16 = sharded_path("16M-4096", params, db, req, exact16, args.seed, gen,
                           ceil["ceilings"])
    emit({"phase_wall_s": {"sharded_16M-4096": time.perf_counter() - t0}})

    if args.profile:
        profile_query(recv, req)
    # -- phase 15, first path: the query's programs against eager() ----------
    progs = {"16M-4096": programs_path("16M-4096", params, db, req, exact16, args.seed)}
    # release the PS path's 4 GB cache before the next path (the recorded
    # K2 call holds a view of it)
    del recv, req, db, cache5, low, runs, calls
    torch.cuda.empty_cache()

    # -- phase 6: the in-process PSU at 1M-2048-cmp (and phase 12 on its DB) --
    psu = psu_path(args, gen, "1M-2048-cmp", ceil["ceilings"], sharded=True)
    if not all(psu["launches"][name] for name in GLUE_NAMES):
        raise AssertionError(f"a glue kernel never launched at 1M-2048-cmp: {psu['launches']}")
    torch.cuda.empty_cache()

    # -- phase 7: the in-process PSU at 1M-2048-com (PS, 29-bit eval primes) --
    psu_ps = psu_path(args, gen, "1M-2048-com", ceil["ceilings"])
    torch.cuda.empty_cache()

    # -- phase 8: run_psu_mpc at 1M-2048-cmp (KKRT, DDH PEQT, OT) -------------
    mpc = mpc_path(args, gen)
    torch.cuda.empty_cache()

    # -- phase 9: the two-process CLI at 1M-2048-com (OSN PEQT, OP_REBIND) ----
    cli = cli_path(args, gen)
    torch.cuda.empty_cache()

    # -- phase 10: the DB lifecycle at 1M-2048-com (mutation, checkpoint) -----
    t0 = time.perf_counter()
    life = db_lifecycle_path(args, gen)
    torch.cuda.empty_cache()

    # -- phase 11: labeled mode at 1M-1-32 -------------------------------------
    t1 = time.perf_counter()
    lab = labeled_path(args, gen, ceil["ceilings"])
    torch.cuda.empty_cache()

    # -- phase 13: the 2 x 2 worker grid through the four CLIs at 1M-2048-com --
    t2 = time.perf_counter()
    grid = grid_path(args, gen)
    emit({"phase_wall_s": {"db_lifecycle": t1 - t0, "labeled": t2 - t1,
                           "worker_grid": time.perf_counter() - t2}})
    torch.cuda.empty_cache()

    # -- phase 14: the in-process PSU at 1M-256-288 (K3 at 520 planes) -------
    t3 = time.perf_counter()
    psu256 = psu_path(args, gen, SMALL_QUERY_SET, ceil["ceilings"], query_items=SMALL_QUERY,
                      common_items=SMALL_COMMON)
    emit({"phase_wall_s": {f"psu_{SMALL_QUERY_SET}": time.perf_counter() - t3}})
    progs.update({"1M-2048-cmp": psu["programs"], "1M-2048-com": psu_ps["programs"],
                  f"labeled_{LABELED_SET}": lab["programs"], SMALL_QUERY_SET: psu256["programs"]})
    emit({"programs_summary": {path: {k: r[k] for k in PROGRAM_SUMMARY} for path, r in progs.items()},
          "gpu": GPU})

    ntt_keys = ("largest_shape", "largest_inverse", "largest_ms", "largest_plain_ms",
                "largest_bound_ms", "largest_bound_by", "device_ms_per_query",
                "bound_ms_per_query")
    ps_keys = ("case", "low", "cache5", "primes_bits", "ms", "plain_ms", "bound_ms")
    big = ntt_ps["largest_shape"]

    def ceiling_keys(work, product):
        t, by = ceiling_ms(work, ceil["ceilings"], product)
        return {"ceiling_ms": t, "ceiling_by": by, "ceiling_product": product}

    def mul_wide_keys(work):
        """K2's or K3's ceiling from the yardstick's work (bytes, 32-bit
        multiplies): each product a 32x32->64 widening multiply, 2 of them."""
        nbytes, mults = work
        return ceiling_keys((nbytes, mults // 2, mults), "mul_wide")

    def ntt_summary(summary, keys=ntt_keys):
        """An NTT summary's keys and its per-query ceiling (Shoup products)."""
        return {**{k: summary[k] for k in keys},
                "ceiling_ms_per_query": sum(ceiling_ms(w[:3], ceil["ceilings"], "shoup_lazy")[0]
                                            * w[3] for w in summary["work_by_shape"])}

    kernels = [
        {"name": "ntt", "route": "cuda", "source": "apsu_tpu_torch/csrc/ntt.cu",
         "replaces": "apsu_tpu/ops/ntt4_pallas.py:504 (N=8192), "
                     "apsu_tpu/ops/ntt_pallas.py:118 (N=2048/4096)",
         "launches": launches["ntt"] + psu["launches"]["ntt"] + psu_ps["launches"]["ntt"]
         + mpc["launches"]["ntt"] + cli["launches"]["ntt"] + life["launches"]["ntt"]
         + lab["launches"]["ntt"] + shard16["launches"]["ntt"]
         + psu["sharded"]["launches"]["ntt"] + grid["launches"]["ntt"]
         + psu256["launches"]["ntt"],
         "launches_by_path": {"ps_16M-4096": launches["ntt"],
                              "psu_1M-2048-cmp": psu["launches"]["ntt"],
                              "psu_1M-2048-com": psu_ps["launches"]["ntt"],
                              "psu_mpc_1M-2048-cmp": mpc["launches"]["ntt"],
                              "cli_1M-2048-com": cli["launches"]["ntt"],
                              "db_lifecycle_1M-2048-com": life["launches"]["ntt"],
                              "labeled_1M-1-32": lab["launches"]["ntt"],
                              "sharded_16M-4096": shard16["launches"]["ntt"],
                              "sharded_1M-2048-cmp": psu["sharded"]["launches"]["ntt"],
                              "grid_1M-2048-com": grid["launches"]["ntt"],
                              f"psu_{SMALL_QUERY_SET}": psu256["launches"]["ntt"]},
         "max_abs_err": max(ntt_ps["max_abs_err"], psu["ntt"]["max_abs_err"],
                            psu_ps["ntt"]["max_abs_err"], mpc["ntt"]["max_abs_err"],
                            cli["ntt"]["max_abs_err"], life["ntt"]["max_abs_err"],
                            lab["ntt"]["max_abs_err"], shard16["ntt"]["max_abs_err"],
                            psu["sharded"]["ntt"]["max_abs_err"], grid["ntt"]["max_abs_err"],
                            psu256["ntt"]["max_abs_err"]),
         "tolerance": TOLERANCE,
         "ms": ntt_ps["largest_ms"], "plain_ms": ntt_ps["largest_plain_ms"],
         "bound_ms": ntt_ps["largest_bound_ms"], "bound_by": ntt_ps["largest_bound_by"],
         **ceiling_keys(ntt_work(big, big[-2], big[-1], ntt_ps["largest_inverse"]),
                        "shoup_lazy"),
         "library_ms": None,
         "shape": ntt_ps["largest_shape"], "inverse": ntt_ps["largest_inverse"],
         "launches_by_tool": {"ntt4p_gl_ab": ceil["ntt_launches"]},
         **ntt_summary(ntt_ps, ("device_ms_per_query", "bound_ms_per_query")),
         "n4096_cmp": ntt_summary(psu["ntt"]),
         "n4096_com": ntt_summary(psu_ps["ntt"]),
         "psu_mpc_1M-2048-cmp": ntt_summary(mpc["ntt"]),
         "cli_1M-2048-com": ntt_summary(cli["ntt"], ntt_keys + ("distinct_shapes",)),
         "db_lifecycle_1M-2048-com": ntt_summary(life["ntt"], ntt_keys + ("distinct_shapes",)),
         "labeled_1M-1-32": ntt_summary(lab["ntt"]),
         "sharded_16M-4096": ntt_summary(shard16["ntt"], ntt_keys + ("distinct_shapes",)),
         "sharded_1M-2048-cmp": ntt_summary(psu["sharded"]["ntt"],
                                            ntt_keys + ("distinct_shapes",)),
         "grid_1M-2048-com": ntt_summary(grid["ntt"], ntt_keys + ("distinct_shapes",)),
         f"psu_{SMALL_QUERY_SET}": ntt_summary(psu256["ntt"])},
        {"name": "ps_inner", "route": "cuda", "source": "apsu_tpu_torch/csrc/ps_inner.cu",
         "replaces": "apsu_tpu/ops/polyeval.py:434",
         "launches": launches["ps_inner"] + psu_ps["launches"]["ps_inner"]
         + cli["launches"]["ps_inner"] + life["launches"]["ps_inner"]
         + shard16["launches"]["ps_inner"] + grid["launches"]["ps_inner"],
         "launches_by_path": {"ps_16M-4096": launches["ps_inner"],
                              "psu_1M-2048-com": psu_ps["launches"]["ps_inner"],
                              "cli_1M-2048-com": cli["launches"]["ps_inner"],
                              "db_lifecycle_1M-2048-com": life["launches"]["ps_inner"],
                              "sharded_16M-4096": shard16["launches"]["ps_inner"],
                              "grid_1M-2048-com": grid["launches"]["ps_inner"]},
         "max_abs_err": max(d["max_abs_err"] for d in [ps, psu_ps["ps_inner"]] + ps_checks
                            + cli["ps_inner"] + life["ps_inner"] + shard16["ps_inner"]
                            + grid["ps_inner"]),
         "tolerance": TOLERANCE,
         "ms": ps["ms"], "plain_ms": ps["plain_ms"],
         "bound_ms": ps["bound_ms"], "bound_by": ps["bound_by"],
         **mul_wide_keys(yardstick.ps_work(ps["low"], ps["cache5"])), "library_ms": None,
         "shape": {"low": ps["low"], "cache5": ps["cache5"]},
         "other_cases": [{**{k: d[k] for k in ps_keys},
                          **mul_wide_keys(yardstick.ps_work(d["low"], d["cache5"]))}
                         for d in [psu_ps["ps_inner"]] + ps_checks + cli["ps_inner"]
                         + life["ps_inner"] + shard16["ps_inner"] + grid["ps_inner"]]},
        {"name": "eval_dot", "route": "cuda", "source": "apsu_tpu_torch/csrc/eval_dot.cu",
         "replaces": "apsu_tpu/ops/polyeval.py:484",
         "launches": psu["launches"]["eval_dot"] + mpc["launches"]["eval_dot"]
         + lab["launches"]["eval_dot"] + psu["sharded"]["launches"]["eval_dot"]
         + psu256["launches"]["eval_dot"],
         "launches_by_path": {"psu_1M-2048-cmp": psu["launches"]["eval_dot"],
                              "psu_mpc_1M-2048-cmp": mpc["launches"]["eval_dot"],
                              "labeled_1M-1-32": lab["launches"]["eval_dot"],
                              "sharded_1M-2048-cmp": psu["sharded"]["launches"]["eval_dot"],
                              f"psu_{SMALL_QUERY_SET}": psu256["launches"]["eval_dot"]},
         "max_abs_err": max([psu["eval_dot"]["max_abs_err"], mpc["eval_dot"]["max_abs_err"],
                             psu256["eval_dot"]["max_abs_err"]]
                            + [d["max_abs_err"] for d in dot_checks + lab["eval_dot"]
                               + psu["sharded"]["eval_dot"]]),
         "tolerance": TOLERANCE,
         "ms": psu["eval_dot"]["ms"], "plain_ms": psu["eval_dot"]["plain_ms"],
         "bound_ms": psu["eval_dot"]["bound_ms"], "bound_by": psu["eval_dot"]["bound_by"],
         **mul_wide_keys(yardstick.dot_work(psu["eval_dot"]["powers"],
                                            psu["eval_dot"]["cache"])),
         "library_ms": None,
         "shape": {"powers": psu["eval_dot"]["powers"], "cache": psu["eval_dot"]["cache"]},
         "other_cases": [{**{k: d[k] for k in ("case", "powers", "cache", "primes_bits", "ms",
                                               "plain_ms", "bound_ms")},
                          **mul_wide_keys(yardstick.dot_work(d["powers"], d["cache"]))}
                         for d in dot_checks + [mpc["eval_dot"]] + lab["eval_dot"]
                         + psu["sharded"]["eval_dot"] + [psu256["eval_dot"]]],
         "labeled_launches_per_query": lab["launches_per_query"]["eval_dot"]},
        *ceil["kernels"],
        *[glue_entry(name, source, replaces, glue_ps[name], psu["glue"][name],
                     {"ps_16M-4096": launches[name], "psu_1M-2048-cmp": psu["launches"][name],
                      "psu_1M-2048-com": psu_ps["launches"][name],
                      "labeled_1M-1-32": lab["launches"][name],
                      "sharded_16M-4096": shard16["launches"][name],
                      "sharded_1M-2048-cmp": psu["sharded"]["launches"][name],
                      f"psu_{SMALL_QUERY_SET}": psu256["launches"][name]},
                     [psu_ps["glue"][name], psu256["glue"][name], lab["glue"][name],
                      shard16["glue"][name], psu["sharded"]["glue"][name]])
          for name, source, replaces, *_ in GLUE_KERNELS],
        {"name": "ctr_mod", "id": "M1", "route": "cuda",
         "source": "apsu_tpu_torch/csrc/ctr_mod.cu",
         "replaces": "none: apsu_tpu/api/parties.py Receiver._prepare draws the mask on the "
                     "host (CsRng.integers)",
         "launches": m1_path["launches"],
         "launches_by_path": {"ps_16M-4096_csrng": m1_path["launches"]},
         "max_abs_err": m1["max_abs_err"], "tolerance": TOLERANCE,
         **{k: m1["cases"][-1][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                             "bound_by", "shape")},
         "library_ms": None, "thread_ops": m1["thread_ops"],
         "other_cases": [{k: c[k] for k in ("cell", "shape", "ms", "eager_ms", "plain_ms",
                                            "bound_ms", "bound_by", "kept_eager_ms",
                                            "kept_bound_ms", "host_us_kept_draw")}
                         for c in m1["cases"]]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def glue_entry(name, source, replaces, main, cmp, by_path, others) -> dict:
    """A glue kernel's entry of the ``kernels`` line: its launches on the
    in-process paths, its largest call of the 16M-4096 warm query (time,
    plain time, bound, measured-stream ceiling) and its per-query sums there
    and at 1M-2048-cmp (``check_glue_calls``)."""
    per_query = ("launches", "device_ms_per_query", "bound_ms_per_query",
                 "ceiling_ms_per_query", "by_wrapper", "ms_by_wrapper", "builds",
                 "general_launches", "largest_wrapper", "largest_ms", "largest_plain_ms",
                 "largest_bound_ms", "largest_ceiling_ms", "largest_shapes")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(d["max_abs_err"] for d in [main, cmp] + others),
            "tolerance": TOLERANCE,
            "ms": main["largest_ms"], "plain_ms": main["largest_plain_ms"],
            "bound_ms": main["largest_bound_ms"], "bound_by": main["largest_bound_by"],
            "ceiling_ms": main["largest_ceiling_ms"], "ceiling_by": main["largest_ceiling_by"],
            "ceiling_product": "shoup_lazy",
            "library_ms": None, "shape": main["largest_shapes"],
            "16M-4096_warm_query": {k: main[k] for k in per_query if k in main},
            "1M-2048-cmp_warm_query": {k: cmp[k] for k in per_query if k in cmp}}


# K3's shapes: (set, level, bundles, caches a bundle, powers, planes); a set
# of None takes two 30-bit primes at N=4096
DOT_CASES = {
    "1M-2048-cmp": ("1M-2048-cmp", "eval", 5, 15, 72, 80),           # phase 6's warm query
    "1M-2048-cmp, 30-bit primes": (None, None, 5, 15, 72, 80),
    "1M-1-32 labeled": ("1M-1-32", "labeled", 1, 5, 228, 232),      # phase 11, twice a query
    "1M-2048-cmp 5-shard shard": ("1M-2048-cmp", "eval", 1, 15, 72, 80),   # phase 12
    "Dp=520, 30-bit primes": (None, None, 1, 3, 519, 520),
    "1M-256-288": ("1M-256-288", "eval", 1, 10, 512, 520),          # phase 14
}


def dot_case(name, gen):
    """Random powers and cache at one of ``DOT_CASES`` on that set's
    evaluation base (or the labeled one): (label, powers, cache, base)."""
    from apsu_tpu_torch.core.nt import gen_ntt_primes
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.core.rns import RnsBase
    from apsu_tpu_torch.db.receiver_db import ReceiverDB

    pset, level, B, C, D, Dp = DOT_CASES[name]
    if pset is None:
        base = RnsBase(gen_ntt_primes([30, 30], 2 * 4096), 4096, "cuda")
    else:
        db = ReceiverDB(PSUParams.load_file(str(ROOT / "parameters" / f"{pset}.json")),
                        device="cuda")
        base = db.bfv.levels[db.labeled_eval_level() if level == "labeled" else db.eval_level()]
    powers = rand_residues((B, D, 2, base.k, base.n), base.primes, gen)
    cache = rand_residues((B, C, Dp, base.k, base.n), base.primes, gen)
    return name, powers, cache, base


def check_dot_cases(gen):
    """The dot-product kernel against its plain version at every shape of
    ``DOT_CASES``."""
    out = []
    for name in DOT_CASES:
        label, powers, cache, base = dot_case(name, gen)
        out.append(check_eval_dot(powers, cache, base, label))
        del powers, cache
    return out


# K2's recorded shapes: bundles (None: the set's), caches per bundle,
# segments (None: the set's) and whether cache5 is the evaluator's strided
# view of the full plane axis
PS_CASES = {
    "1M-2048-com": (None, 9, None, True),   # the warm query and the CLI
    "16M-4096": (None, 6, None, True),      # the main path
    "1M-4096-com": (None, 6, None, False),  # 30-bit eval primes, ph=9
    "256M-1": (1, 2, 2, False),             # ph=311, cut to a few hundred MB
}


def ps_inner_case(name, gen):
    """Random low powers and cache at one of ``PS_CASES`` on that set's
    evaluation base: (label, low, cache5, base)."""
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.ops import polyeval

    B, C, nseg, view = PS_CASES[name]
    params = PSUParams.load_file(str(ROOT / "parameters" / f"{name}.json"))
    db = ReceiverDB(params, device="cuda")
    q = db.bfv.levels[db.ps_level()]
    N, qp = params.poly_degree, params.query_params
    ph = qp.ps_low_degree + 1
    B = B or params.bundle_idx_count
    planes = polyeval.plane_count(params.table_params.max_items_per_bin, qp.ps_low_degree)
    nseg = nseg or planes // ph
    low = rand_residues((B, ph - 1, 2, q.k, N), q.primes, gen)
    if view:
        cache = rand_residues((B * C, planes, q.k, N), q.primes, gen)
        cache5 = cache[:, : nseg * ph].reshape(B * C, nseg, ph, q.k, N)
    else:
        cache5 = rand_residues((B * C, nseg, ph, q.k, N), q.primes, gen)
    return f"{name} eval primes, ph={ph}", low, cache5, q


def check_ps_wide_cases(gen):
    """The PS inner-sum kernel at wide primes and ph against its plain version:
    the 1M-4096-com evaluation shape (its three 30-bit eval primes, ph=9,
    B=5 bundles of 6 caches, 104 planes) and ph=311 at 256M-1's six eval
    primes (30 and 29 bits), with B=1, C=2 and two segments so that it fits a
    few hundred MB."""
    out = []
    for name in ("1M-4096-com", "256M-1"):
        label, low, cache5, q = ps_inner_case(name, gen)
        out.append(check_ps_inner(low, cache5, q, label))
        del low, cache5
    return out


def ceilings_phase() -> dict:
    """Phase 3.  K9 (``vpu_loop``) against its plain version on the reference
    tool's (8, 512, 128) block, each arm at outer = 2 and at the tool's 256;
    K10 (``add_one``) at [64, 7, 8192] on random u32 values and on values
    just below 2^32 (which wrap), and at the stream's 1 GiB, where its plain
    version is timed.  Then both measuring tools, each with the launch counts
    set to 0 just before it and read just after (a rate above 105% of its
    published figure raises in the tool), and the ``ceilings`` line.
    Returns the two kernels' entries of the ``kernels`` line (K9 at the
    tool's block and 256 rounds, summed over the arms; K10 at the stream's
    1 GiB, one launch) and the measured ceilings: the faster of K10's and
    ``torch.add``'s streams, and each product's rate from one launch of 256
    rounds."""
    from apsu_tpu_torch.core.mod32 import from_u32
    from apsu_tpu_torch.ops import roofline
    from apsu_tpu_torch.tools import graph_ms, ntt4p_gl_ab, vpu_roofline, window_ms

    sass = vpu_roofline.sass_per_step()
    shape, outer = (8, 512, 128), 256   # the reference tool's block and rounds
    x = from_u32(np.random.default_rng(0).integers(1, 1 << 28, shape, np.uint64)
                 .astype(np.uint32), "cuda")
    arms = {}
    for op in roofline.OPS:
        res = {"max_abs_err": 0}
        for rounds in (2, outer):   # plain_ms is the last: the tool's rounds
            k = roofline.vpu_loop_cuda(x, op, rounds)
            pl, plain_ms = window_ms(lambda: roofline.vpu_loop_plain(x, op, rounds))
            err = max_abs_err(k, pl)
            if err > TOLERANCE or not torch.equal(k, pl):
                raise AssertionError(f"vpu_loop kernel != plain ({op}, outer={rounds}): {err}")
            res["max_abs_err"] = max(res["max_abs_err"], err)
        # the least instructions a step needs on its busier pipe, at one
        # pipe's INT32 rate (the compiled loop's SASS count is beside it)
        least = vpu_roofline.MIN_PER_STEP[op]
        b_ms, b_by = bound_ms(2 * x.numel() * 4, x.numel() * roofline.REPS * outer
                              * max(least.values()))
        arms[op] = {**res, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "outer_2_ms": graph_ms(lambda: roofline.vpu_loop_cuda(x, op, 2)),
                    "min_per_step": least, "sass_per_step": sass[op]}
        del k, pl
    emit({"check": "vpu_loop", "shape": list(shape), "outer": [2, 256], "tolerance": TOLERANCE,
          "arms": arms})
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    add_cases = {}
    for label, lo in [("random u32", 0), ("just below 2^32", (1 << 32) - 16)]:
        # int64 u32 values cast to their int32 bits
        y = torch.randint(lo, 1 << 32, (64, 7, 8192), dtype=torch.int64, device="cuda",
                          generator=gen).to(torch.int32)
        k = roofline.add_one_cuda(y)
        pl = roofline.add_one_plain(y)
        err = max_abs_err(k, pl)
        if err > TOLERANCE or not torch.equal(k, pl):
            raise AssertionError(f"add_one kernel != plain ({label}): {err}")
        add_cases[label] = {"max_abs_err": err, "wrapped": int((k == 0).sum())}
    if add_cases["just below 2^32"]["wrapped"] == 0:
        raise AssertionError("no value wrapped in add_one's wrap case")
    # replayed at this shape its 29 MB in and out stay in the 50 MB L2
    emit({"check": "add_one", "shape": list(y.shape), "tolerance": TOLERANCE, "cases": add_cases,
          "l2_resident_ms": graph_ms(lambda: roofline.add_one_cuda(y)),
          "l2_resident_torch_add_ms": graph_ms(lambda: torch.add(y, 1))})
    del x, y, k, pl
    # the stream's 1 GiB launch, against the plain version that is timed
    big = torch.randint(0, 1 << 30, (1 << 28,), dtype=torch.int32, device="cuda", generator=gen)
    roofline.add_one_plain(big)
    pl, add_plain_ms = window_ms(lambda: roofline.add_one_plain(big))
    k = roofline.add_one_cuda(big)
    err = max_abs_err(k, pl)
    if err > TOLERANCE or not torch.equal(k, pl):
        raise AssertionError(f"add_one kernel != plain (1 GiB): {err}")
    add_cases["1 GiB stream"] = {"max_abs_err": err}
    emit({"check": "add_one", "shape": list(big.shape), "tolerance": TOLERANCE,
          "cases": {"1 GiB stream": add_cases["1 GiB stream"]}, "plain_ms": add_plain_ms})
    del big, k, pl
    torch.cuda.empty_cache()

    # the tools' paths: counts set to 0 just before each, read just after
    # (with the card's SM clock and power draw sampled every 100 ms meanwhile)
    runs, launches, clocks = {}, {}, {}
    for name, measure in [("vpu_roofline", lambda: vpu_roofline.measure("cuda", shape, outer)),
                          ("ntt4p_gl_ab", lambda: ntt4p_gl_ab.measure("cuda"))]:
        smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                "--format=csv,noheader,nounits", "-lms", "100"],
                               stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        try:
            reset_launches()
            t0 = time.perf_counter()
            runs[name] = measure()
            counted = launch_counts()
            launches[name] = {"vpu_loop": counted["vpu_loop"], "add_one": counted["add_one"],
                              "ntt": counted["ntt"], "wall_s": time.perf_counter() - t0}
        finally:
            smi.terminate()
            samples, _ = smi.communicate(timeout=30)
        pairs = [[float(v) for v in ln.split(",")] for ln in samples.splitlines()
                 if re.fullmatch(r"\s*[\d.]+\s*,\s*[\d.]+\s*", ln)]
        clocks[name] = {"samples": len(pairs),
                        "sm_mhz": sorted({int(c) for c, _ in pairs}),
                        "max_power_w": max((w for _, w in pairs), default=None)}
        torch.cuda.empty_cache()
    roof, gl = runs["vpu_roofline"], runs["ntt4p_gl_ab"]
    for arm in roof["arms"]:
        emit({"vpu_roofline": arm["arm"], **arm})
    emit({"vpu_roofline": "stream", **roof["stream"]})
    for row in gl["rows"]:
        emit({"ntt4p_gl_ab": row})
    emit({"tool_launches": launches, "tool_clocks": clocks})
    if (launches["vpu_roofline"]["vpu_loop"] == 0 or launches["vpu_roofline"]["add_one"] == 0
            or launches["ntt4p_gl_ab"]["add_one"] == 0 or launches["ntt4p_gl_ab"]["ntt"] == 0):
        raise AssertionError(f"a kernel of the tools' paths never launched: {launches}")
    if not all(row["bit_identical"] for row in gl["rows"]):
        raise AssertionError("ntt4p_gl_ab: K1 != ntt_plain on a row")
    if not all(row["add_one_identical"] for row in gl["rows"]):
        raise AssertionError("ntt4p_gl_ab: K10 != add_one_plain on a row")

    s = roof["stream"]
    ceilings = {
        "device": roof["device"], "clocks_during_vpu_roofline": clocks["vpu_roofline"],
        "stream_bytes_per_s": max(s["bytes_per_s"], s["torch_add_bytes_per_s"]),
        "add_one_bytes_per_s": s["bytes_per_s"], "torch_add_bytes_per_s": s["torch_add_bytes_per_s"],
        "products_per_s": {a["arm"]: a["steps_per_s"] for a in roof["arms"]},
        "graph_products_per_s": {a["arm"]: a["graph_steps_per_s"] for a in roof["arms"]},
        "sass_ops_per_s": {a["arm"]: a["ops_per_s"] for a in roof["arms"]},
        "sass_per_step": sass,
        "min_per_step": vpu_roofline.MIN_PER_STEP,
        "arm_share_of_bound": {a["arm"]: a["share_of_bound"] for a in roof["arms"]},
        "share_of_published": {
            "add_one_stream": s["bytes_per_s"] / yardstick.HBM_BYTES_PER_S,
            "torch_add_stream": s["torch_add_bytes_per_s"] / yardstick.HBM_BYTES_PER_S,
            **{a["arm"]: a["busiest_pipe_ops_per_s"] / yardstick.INT32_OPS_PER_S
               for a in roof["arms"]}},
        "per_call_floor_ms": [{k: row[k] for k in ("L", "B", "add_one_graph_ms", "add_one_eager_ms",
                                                    "torch_add_eager_ms", "l2_resident")}
                              for row in gl["rows"]],
    }
    emit({"ceilings": ceilings})
    tool_ms = {a["arm"]: a["ms"] for a in roof["arms"]}
    k9 = {"name": "vpu_loop", "route": "cuda", "source": "apsu_tpu_torch/csrc/roofline.cu",
          "replaces": "tools/vpu_roofline.py:103",
          "launches": launches["vpu_roofline"]["vpu_loop"],
          "launches_by_path": {"vpu_roofline": launches["vpu_roofline"]["vpu_loop"]},
          "max_abs_err": max(a["max_abs_err"] for a in arms.values()), "tolerance": TOLERANCE,
          "ms": sum(tool_ms.values()),
          **{key: sum(a[key] for a in arms.values()) for key in ("plain_ms", "bound_ms")},
          "bound_by": "operations", "library_ms": None,
          "shape": list(shape), "outer": outer, "sums_over": list(roofline.OPS),
          "arms": {op: {"ms": tool_ms[op], "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"]}
                   for op, a in arms.items()}}
    stream_bytes = 2 * s["buffer_bytes"]
    k10 = {"name": "add_one", "route": "cuda", "source": "apsu_tpu_torch/csrc/roofline.cu",
           "replaces": "tools/ntt4p_gl_ab.py:65",
           "launches": launches["vpu_roofline"]["add_one"] + launches["ntt4p_gl_ab"]["add_one"],
           "launches_by_path": {k: v["add_one"] for k, v in launches.items()},
           "max_abs_err": max(c["max_abs_err"] for c in add_cases.values()),
           "tolerance": TOLERANCE, "ms": s["ms"] / s["launches_a_window"],
           "plain_ms": add_plain_ms, "bound_ms": stream_bytes / yardstick.HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": s["torch_add_ms"] / s["launches_a_window"],
           "shape": [s["elems"]]}
    return {"kernels": [k9, k10], "ceilings": ceilings,
            "ntt_launches": launches["ntt4p_gl_ab"]["ntt"]}


def sass_functions(lib, pattern: str) -> list:
    """The SASS text of each kernel in ``lib`` whose mangled name matches."""
    from apsu_tpu_torch.ops import _build

    dump = subprocess.run([str(Path(_build._nvcc()).parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    return [f for f in re.split(r"\n\s*Function : ", dump)[1:]
            if re.search(pattern, f.split("\n", 1)[0])]


def psu_path(args, gen, name: str, ceilings: dict, sharded: bool = False,
             query_items: int = QUERY_ITEMS, common_items: int = COMMON_ITEMS) -> dict:
    """run_psu at ``name`` at full width, 2^20 receiver items against
    ``query_items`` sender items of which ``common_items`` are in the DB,
    then warm queries: phase 6 on the non-PS 1M-2048-cmp (kernel K3), phase
    7 on the PS 1M-2048-com (K2), phase 14 on the non-PS 1M-256-288 (K3 at
    520 planes).  With ``sharded``, phase 12 (``sharded_path``) on the same
    DB and request follows."""
    from apsu_tpu_torch.api.parties import Receiver, Sender, _slots_to_item_blocks
    from apsu_tpu_torch.api.protocol import DebugEndgame, run_psu
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.mpc.oprf import DebugOprf

    params = PSUParams.load_file(str(ROOT / "parameters" / f"{name}.json"))
    ps = params.query_params.ps_low_degree > 0
    kernel, other = ("ps_inner", "eval_dot") if ps else ("eval_dot", "ps_inner")
    rng = np.random.default_rng(args.seed)
    db_items, query = make_sets(rng, DB_ITEMS, query_items, common_items)
    db_set, q_set = as_set(db_items), as_set(query)
    want = q_set - db_set
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = ReceiverDB(params, DebugOprf(), device="cuda")
    stats = db.set_data(db_items)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = launch_counts()
    snd = Sender(params, DebugOprf(), rng=np.random.default_rng(args.seed + 2), device="cuda")
    recv = Receiver(params, db, rng=np.random.default_rng(args.seed + 3))
    reset_launches()
    res = run_psu(params, query, db_items, sender=snd, receiver=recv)
    torch.cuda.synchronize()
    psu_launches = launch_counts()
    transferred, union = as_set(res.transferred), as_set(res.union)
    psu_ok = transferred == want and union == db_set | q_set and not transferred & db_set
    emit({"psu_path": name, "db_items": len(db_items), "query_items": len(query),
          "common_items": common_items, "db_build_s": build_s,
          "timings": {**res.timings, "db_build": build_s},
          "stats": {"n_insertions": stats.n_insertions, "n_caches": stats.n_caches,
                    "max_bin_load": stats.max_bin_load},
          "cache_shape": list(db.coeff_cache.shape),
          "cache_gb": db.coeff_cache.numel() * 4 / 1e9, "eval_level": db.eval_lvl,
          "build_launches": build_launches, "run_psu_launches": psu_launches,
          "transferred": len(res.transferred), "union": len(res.union),
          "expected_transferred": len(want), "oracle_exact": psu_ok})
    if not psu_ok:
        raise AssertionError("run_psu set-algebra oracle failed")

    # warm queries on the same request: each response against its own mask
    req = snd.create_query(query)
    calls = kernel_calls()  # the kernel launches of the recorded (eager) query
    runs, query_launches, per_query = query_runs(recv, req, calls)
    launches = {k: psu_launches[k] + query_launches[k] for k in query_launches}

    def endgame(resp, mask):
        got = DebugEndgame().run(
            snd.peqt_matrix(snd.extract_matrix(resp)), _slots_to_item_blocks(params, mask),
            snd.cuckoo.table, snd.cuckoo.filled)
        return as_set(got) == want, len(got)

    oracles = [endgame(resp, mask) for resp, mask, *_ in runs]
    control = endgame(runs[-1][0], runs[0][1])
    warm = [t for _, _, t, how in runs if how == "graph"]
    emit({"psu_first_query_s": runs[0][2], "psu_warm_query_s": warm,
          "psu_warm_best_s": min(warm), "eager_recorded_query_s": runs[-1][2],
          "bundles_per_s": db.coeff_cache.shape[0] * db.coeff_cache.shape[1] / min(warm),
          "queries": [how for *_, how in runs],
          "oracle_per_query": [list(o) for o in oracles], "control_other_mask": list(control),
          "launches": launches, "launches_per_query": per_query,
          "result_shape": list(runs[-1][0].results.shape),
          "result_checksums": [int(r.results.to(torch.int64).sum()) for r, *_ in runs],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not all(ok for ok, _ in oracles):
        raise AssertionError("warm-query oracle failed")
    if control[0]:
        raise AssertionError("the oracle accepted a response checked against another mask")
    if launches[kernel] == 0 or launches["ntt"] == 0 or launches[other]:
        raise AssertionError(f"the {name} path's launches are wrong: {launches}")

    # the kernels at the shapes the last warm query launched them with
    ntt_summary = check_ntt_shapes(calls["ntt"], gen)
    if ntt_summary["n"] != [params.poly_degree]:
        raise AssertionError(f"NTT launched at N={ntt_summary['n']}")
    emit({"psu_ntt_warm_query": ntt_summary, "path": name})
    if ps:
        checks = []
        for low_shape, cache5, base in calls["ps_inner"]:
            low = rand_residues(low_shape, base.primes, gen)
            checks.append(check_ps_inner(low, cache5, base, f"{name} warm query (DB cache)"))
        evals = max(checks, key=lambda c: c["ms"])
    else:
        (pw_shape, cache, base), = calls["eval_dot"]
        powers = rand_residues(pw_shape, base.primes, gen)
        evals = check_eval_dot(powers, cache, base, f"{name} warm query (DB cache)")
    glue = check_glue_calls(calls["glue"], f"{name} warm query", ceilings)
    if args.profile:
        profile_query(recv, req)
    out = {"launches": launches, "ntt": ntt_summary, kernel: evals, "glue": glue,
           "launches_per_query": per_query}
    if sharded:
        t0 = time.perf_counter()
        out["sharded"] = sharded_path(name, params, db, req,
                                      lambda resp, mask: endgame(resp, mask)[0], args.seed, gen,
                                      ceilings)
        emit({"phase_wall_s": {f"sharded_{name}": time.perf_counter() - t0}})
    fresh = np.random.default_rng(args.seed + 4).integers(0, 1 << 64, size=(MUTATED_ITEMS, 2),
                                                          dtype=np.uint64)
    out["programs"] = programs_path(name, params, db, req,
                                    lambda resp, mask: endgame(resp, mask)[0], args.seed,
                                    fresh=fresh[[(int(x), int(y)) not in q_set for x, y in fresh]])
    return out


class _Records(logging.Handler):
    """Keeps the messages logged while it is attached."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def ot_flavors(messages) -> list:
    """The OT extensions a run made, from ``mpc/otext.py``'s debug lines:
    [OTs, flavour, k, role] each."""
    out = []
    for msg in messages:
        m = re.search(r"OT extension: (\d+) OTs, (\w+) k=(\d+) \((\w+)\)", msg)
        if m:
            out.append([int(m[1]), m[2], int(m[3]), m[4]])
    return out


def mpc_path(args, gen) -> dict:
    """Phase 8: ``run_psu_mpc`` at 1M-2048-cmp, full width, with the KKRT
    OPRF, the DDH PEQT and union mode; both parties' kernel calls recorded
    and the kernels checked at those shapes afterwards."""
    from apsu_tpu_torch.api.protocol import run_psu_mpc
    from apsu_tpu_torch.core.params import PSUParams

    name = "1M-2048-cmp"
    params = PSUParams.load_file(str(ROOT / "parameters" / f"{name}.json"))
    db_items, query = make_sets(np.random.default_rng(args.seed), DB_ITEMS, QUERY_ITEMS,
                                COMMON_ITEMS)
    _, other = make_sets(np.random.default_rng(args.seed + 7), 16, QUERY_ITEMS, 0)
    db_set, q_set = as_set(db_items), as_set(query)

    calls = kernel_calls()
    records = _Records()
    logger = logging.getLogger("apsu_tpu_torch")
    level = logger.level
    logger.addHandler(records)
    logger.setLevel(logging.DEBUG)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with recording_kernels(calls):
            res = run_psu_mpc(params, query, db_items, seed=args.seed + 11, peqt="ddh")
            torch.cuda.synchronize()
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    transferred, union = as_set(res.transferred), as_set(res.union)
    exact = (transferred == q_set - db_set and union == db_set | q_set
             and not transferred & db_set and len(union) == len(db_set) + len(q_set - db_set))
    control = transferred == as_set(other) - db_set
    emit({"psu_mpc_path": name, "oprf": "kkrt", "peqt": "ddh", "mode": "union",
          "db_items": len(db_items), "query_items": len(query), "common_items": COMMON_ITEMS,
          "wall_s": wall, "timings": res.timings, "bytes_on_wire": res.timings["bytes_on_wire"],
          "transferred": len(res.transferred), "union": len(res.union),
          "expected_transferred": len(q_set - db_set), "oracle_exact": exact,
          "control_other_query_passes": control, "ot_flavors": ot_flavors(records.messages),
          "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not exact:
        raise AssertionError("run_psu_mpc set-algebra oracle failed")
    if control:
        raise AssertionError("the oracle accepted the union against another query's set")
    if launches["ntt"] == 0 or launches["eval_dot"] == 0 or launches["ps_inner"]:
        raise AssertionError(f"the run_psu_mpc path's launches are wrong: {launches}")

    # the kernels at the shapes this run launched them with (DB build, both
    # parties' BFV work and the query)
    ntt_summary = check_ntt_shapes(calls["ntt"], gen)
    emit({"psu_mpc_ntt": ntt_summary, "path": name})
    (pw_shape, cache, base), = calls["eval_dot"]
    powers = rand_residues(pw_shape, base.primes, gen)
    evals = check_eval_dot(powers, cache, base, f"{name} run_psu_mpc query (DB cache)")
    return {"launches": launches, "ntt": ntt_summary, "eval_dot": evals}


def cli_path(args, gen) -> dict:
    """Phase 9: ``receiver_cli --serve 2`` and ``sender_cli --peqt osn`` as two
    processes on the card over TCP at 1M-2048-com, two KKRT queries on one
    connection (the second through OP_REBIND).  Each process runs its CLI
    module as ``python -m`` would, under ``cli_child``, which records every
    kernel call (DB build, rebind, queries, the sender's encryption, keys and
    decryption); afterwards each kernel is held against its plain version at
    every recorded shape."""
    name = "1M-2048-com"
    rng = np.random.default_rng(args.seed)
    db = [f"db-item-{i}" for i in range(DB_ITEMS)]
    picks = rng.choice(DB_ITEMS, size=2 * COMMON_ITEMS, replace=False)
    queries = [[f"query{k}-item-{i}" for i in range(QUERY_ITEMS - COMMON_ITEMS)]
               + [db[j] for j in picks[k * COMMON_ITEMS:(k + 1) * COMMON_ITEMS]]
               for k in range(2)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli-", dir=ROOT) as tmp:
        tmp = Path(tmp)
        for fname, rows in [("db.csv", db), ("query0.csv", queries[0]),
                            ("query1.csv", queries[1])]:
            (tmp / fname).write_text("".join(r + "\n" for r in rows))
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        common = ["--port", port, "--log-level", "debug", "--device", CLI_DEVICE]

        def child(module, record):
            return [sys.executable, str(ROOT / "chip_smoke.py"), "--cli-child",
                    str(tmp / record), f"apsu_tpu_torch.cli.{module}"]

        recv = subprocess.Popen(
            [*child("receiver_cli", "receiver_calls.json"), "--params",
             str(ROOT / "parameters" / f"{name}.json"), "--db-file", str(tmp / "db.csv"),
             "--bind", "127.0.0.1", "--out", str(tmp / "union.csv"), "--serve", "2",
             "--seed", str(args.seed + 1), *common],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        recv_lines = []
        reader = threading.Thread(target=lambda: recv_lines.extend(recv.stderr), daemon=True)
        reader.start()
        t0 = time.perf_counter()
        try:
            # the receiver logs this line once its socket is bound
            while not any("listening on" in ln for ln in recv_lines):
                if recv.poll() is not None or time.perf_counter() - t0 > CLI_TIMEOUT:
                    raise RuntimeError("receiver_cli did not listen:\n"
                                       + "".join(recv_lines)[-3000:])
                time.sleep(0.2)
            send = subprocess.run(
                [*child("sender_cli", "sender_calls.json"), "--query-file",
                 str(tmp / "query0.csv"), str(tmp / "query1.csv"), "--host", "127.0.0.1",
                 "--peqt", "osn", "--seed", str(args.seed + 2), *common],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                text=True, timeout=CLI_TIMEOUT)
            rc = recv.wait(timeout=CLI_TIMEOUT)
        finally:
            if recv.poll() is None:
                recv.kill()
                recv.wait()
        wall = time.perf_counter() - t0
        reader.join(30)
        recv_log = "".join(recv_lines)
        if send.returncode != 0 or rc != 0:
            raise RuntimeError(f"CLI failed: sender rc {send.returncode}, receiver rc {rc}\n"
                               f"{send.stderr[-3000:]}\n{recv_log[-3000:]}")
        union = set((tmp / "union.csv").read_text().split())
        recorded = [json.loads((tmp / f).read_text())
                    for f in ("receiver_calls.json", "sender_calls.json")]

    want = set(db) | set(queries[0]) | set(queries[1])
    new = int(logged(r"\(2 queries, received (\d+) new\)", recv_log))
    fresh = 2 * (QUERY_ITEMS - COMMON_ITEMS)
    timings = ast.literal_eval(logged(r"timings: (\{.*\})", recv_log))
    recv_launches = json.loads(logged(r"kernel launches: (\{.*\})", recv_log))
    send_launches = json.loads(logged(r"kernel launches: (\{.*\})", send.stderr))
    launches = {k: recv_launches[k] + send_launches[k] for k in recv_launches}
    # repair 14(b): the consumed cache is freed before the rebind builds the next
    mem = [float(x) for x in logged(
        r"rebind: device memory allocated ([\d.]+) GB before, ([\d.]+) GB after releasing "
        r"the consumed cache, ([\d.]+) GB after the rebind \(cache ([\d.]+) GB\)", recv_log)]
    rebind_mem = dict(zip(("before", "after_release", "after_rebind", "cache"), mem))
    res = {"cli_path": name, "processes": ["receiver_cli --serve 2", "sender_cli --peqt osn"],
           "db_items": len(db), "query_items": [len(q) for q in queries],
           "common_items_each": COMMON_ITEMS, "wall_s": wall,
           "union": len(union), "expected_union": len(want), "union_exact": union == want,
           "received_new": new, "expected_new": fresh,
           "receiver_timings": timings, "receiver_rebind_mem_gb": rebind_mem,
           "receiver_peak_mem_gb": float(logged(r"peak device memory: ([\d.]+) GB", recv_log)),
           "sender_peak_mem_gb": float(logged(r"peak device memory: ([\d.]+) GB", send.stderr)),
           "receiver_bytes": logged(r"bytes sent=\d+ received=\d+", recv_log),
           "launches_receiver": recv_launches, "launches_sender": send_launches,
           "ot_flavors_receiver": ot_flavors(recv_log.splitlines()),
           "ot_flavors_sender": ot_flavors(send.stderr.splitlines())}
    emit(res)
    if union != want or new != fresh:
        raise AssertionError("the CLI's union.csv is not the union of the CSVs")
    if "rebind" not in timings:
        raise AssertionError("the second query did not go through OP_REBIND")
    if launches["ntt"] == 0 or launches["ps_inner"] == 0 or launches["eval_dot"]:
        raise AssertionError(f"the CLI path's launches are wrong: {launches}")
    counted = recorded_launches(recorded)
    if counted != launches:
        raise AssertionError(f"recorded calls {counted} != logged launches {launches}")
    if rebind_mem["before"] - rebind_mem["after_release"] < rebind_mem["cache"] - 1e-3:
        raise AssertionError(f"the rebind did not free the consumed cache first: {rebind_mem}")

    # the kernels at every shape the two processes launched them with
    checks = replay_calls(recorded, gen, f"{name} CLI")
    emit({"cli_ntt": checks["ntt"], "path": name})
    return {"launches": launches, **checks}


def _changed_sets(params, rng):
    """Phase 10's items: the DB's 2^20, the CHANGED_ITEMS inserted (GROW_ITEMS
    of them located on the fullest slot) and the CHANGED_ITEMS removed, and
    the 2048-item query: 1024 in the final set (QUERY_CHANGED of them
    inserted), QUERY_CHANGED removed ones, the rest in neither."""
    from apsu_tpu_torch.hash.items import LocFuncs

    tp = params.table_params
    locs = LocFuncs(tp.table_size, tp.hash_func_count, LOC_SEED)
    db_items = rng.integers(0, 1 << 64, size=(DB_ITEMS, 2), dtype=np.uint64)
    fullest = int(np.argmax(np.bincount(locs.locations(db_items).reshape(-1),
                                        minlength=tp.table_size)))
    cand = rng.integers(0, 1 << 64, size=(2 * GROW_ITEMS * tp.table_size // tp.hash_func_count,
                                          2), dtype=np.uint64)
    on_fullest = cand[(locs.locations(cand) == fullest).any(axis=1)][:GROW_ITEMS]
    new_items = np.concatenate([
        rng.integers(0, 1 << 64, size=(CHANGED_ITEMS - len(on_fullest), 2), dtype=np.uint64),
        on_fullest])
    gone_idx = rng.choice(DB_ITEMS, size=CHANGED_ITEMS, replace=False)
    kept = np.ones(DB_ITEMS, dtype=bool)
    kept[gone_idx] = False
    gone = db_items[gone_idx]
    final = np.concatenate([db_items[kept], new_items])
    old = db_items[kept][rng.choice(int(kept.sum()), size=COMMON_ITEMS - QUERY_CHANGED,
                                    replace=False)]
    query = np.concatenate([
        old, new_items[rng.choice(CHANGED_ITEMS, size=QUERY_CHANGED, replace=False)],
        gone[:QUERY_CHANGED],
        rng.integers(0, 1 << 64, size=(QUERY_ITEMS - COMMON_ITEMS - QUERY_CHANGED, 2),
                     dtype=np.uint64)])
    rng.shuffle(query)
    return db_items, new_items, gone, final, query, len(on_fullest)


def db_lifecycle_path(args, gen) -> dict:
    """Phase 10: the receiver DB's lifecycle at 1M-2048-com (PS: K1, K2) with
    every kernel call recorded (shapes only), then each kernel held against
    its plain version at every recorded call."""
    from apsu_tpu_torch.api.parties import Receiver, Sender
    from apsu_tpu_torch.api.protocol import run_psu
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.mpc.oprf import DebugOprf

    name = "1M-2048-com"
    params = PSUParams.load_file(str(ROOT / "parameters" / f"{name}.json"))
    rng = np.random.default_rng(args.seed + 20)
    db_items, new_items, gone, final, query, on_fullest = _changed_sets(params, rng)
    final_set, gone_set, q_set = as_set(final), as_set(gone), as_set(query)
    absent = rng.integers(0, 1 << 64, size=(COMMON_ITEMS, 2), dtype=np.uint64)
    present = db_items[rng.choice(DB_ITEMS, size=COMMON_ITEMS, replace=False)]

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    calls = kernel_calls()
    records = _Records()
    logger = logging.getLogger("apsu_tpu_torch")
    level = logger.level
    res = {"db_lifecycle_path": name, "loc_seed": LOC_SEED.decode(), "db_items": DB_ITEMS,
           "inserted": CHANGED_ITEMS, "inserted_on_fullest_slot": on_fullest,
           "removed": CHANGED_ITEMS, "query_items": len(query), "seconds": {}}
    sec = res["seconds"]
    reset_launches()
    with recording_kernels(calls, keep=False), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt-", dir=ROOT) as ckpt:
        db = ReceiverDB(params, DebugOprf(), loc_seed=LOC_SEED, device="cuda")
        stats, sec["set_data"] = synced(lambda: db.set_data(db_items))
        cache_gb = db.coeff_cache.numel() * 4 / 1e9
        res["built"] = {"n_caches": stats.n_caches, "max_bin_load": stats.max_bin_load,
                        "cache_shape": list(db.coeff_cache.shape), "cache_gb": cache_gb}
        has = {"present": int(db.has_item(present).sum()), "absent": int(db.has_item(absent).sum())}
        res["has_item"] = has
        if has != {"present": COMMON_ITEMS, "absent": 0}:
            raise AssertionError(f"has_item is not exact: {has}")

        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        logger.addHandler(records)
        logger.setLevel(logging.DEBUG)
        try:
            stats, sec["insert"] = synced(lambda: db.insert_or_assign(new_items))
        finally:
            logger.removeHandler(records)
            logger.setLevel(level)
        grow_peak = torch.cuda.max_memory_allocated()
        grown = [m for m in records.messages if "grows the cache axis" in m]
        res["insert"] = {"n_caches": stats.n_caches, "cache_shape": list(db.coeff_cache.shape),
                         "grow_log": grown, "allocated_before_gb": mem_before / 1e9,
                         "peak_gb": grow_peak / 1e9,
                         "peak_above_before_gb": (grow_peak - mem_before) / 1e9,
                         "new_cache_gb": db.coeff_cache.numel() * 4 / 1e9}
        if not grown or stats.n_caches <= res["built"]["n_caches"]:
            raise AssertionError(f"the insert did not grow the cache axis: {res['insert']}")
        before, after_release, old_gb = (float(x) for x in re.search(
            r"allocated ([\d.]+) GB before, ([\d.]+) GB after releasing the old cache "
            r"\(([\d.]+) GB\)", grown[0]).groups())
        if before - after_release < old_gb - 1e-3:
            raise AssertionError(f"the grow path did not free the old cache first: {grown[0]}")
        if grow_peak - (mem_before - cache_gb * 1e9) >= 2 * res["insert"]["new_cache_gb"] * 1e9:
            raise AssertionError(f"the grow path held two caches: {res['insert']}")

        stats, sec["remove"] = synced(lambda: db.remove(gone))
        res["removed_stats"] = {"n_items": stats.n_items, "n_insertions": stats.n_insertions,
                                "n_caches": stats.n_caches}
        if db.has_item(gone).any() or not db.has_item(new_items).all():
            raise AssertionError("has_item disagrees with the inserts and removals")

        snd = Sender(params, DebugOprf(), rng=np.random.default_rng(args.seed + 21),
                     loc_seed=LOC_SEED, device="cuda")
        recv = Receiver(params, db, rng=np.random.default_rng(args.seed + 22))
        psu, sec["run_psu"] = synced(lambda: run_psu(params, query, final, sender=snd,
                                                     receiver=recv))
        transferred, union = as_set(psu.transferred), as_set(psu.union)
        exact = (transferred == q_set - final_set and union == final_set | q_set
                 and not transferred & final_set)
        # control: the removed items taken as members
        control = transferred == q_set - (final_set | gone_set)
        res["run_psu"] = {"transferred": len(transferred), "expected": len(q_set - final_set),
                          "removed_in_query_transferred": len(transferred & gone_set),
                          "oracle_exact": exact, "control_removed_as_members_passes": control}
        if not exact:
            raise AssertionError("run_psu after insert/remove: set-algebra oracle failed")
        if control:
            raise AssertionError("the oracle accepted the removed items as members")

        db.strip()
        try:
            db.insert_or_assign(new_items[:4])
            raise AssertionError("a stripped DB accepted insert_or_assign")
        except ValueError:
            pass
        _, sec["save"] = synced(lambda: db.save(ckpt))
        files = sorted(os.listdir(ckpt))
        res["checkpoint"] = {"files": files,
                             "bytes": sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)}
        loaded, sec["load"] = synced(lambda: ReceiverDB.load(ckpt, oprf=DebugOprf(),
                                                             device="cuda"))
        req = Sender(params, DebugOprf(), rng=np.random.default_rng(args.seed + 23),
                     loc_seed=LOC_SEED, device="cuda").create_query(query)
        resp = Receiver(params, db, rng=np.random.default_rng(args.seed + 24)).run_query(req)
        resp_l = Receiver(params, loaded, rng=np.random.default_rng(args.seed + 24)).run_query(req)
        same = torch.equal(resp.results, resp_l.results)
        res["checkpoint"].update({"loaded_equals_stripped": same,
                                  "checksums": [int(r.results.to(torch.int64).sum())
                                                for r in (resp, resp_l)]})
        if not same:
            raise AssertionError("the loaded DB's response differs from the stripped DB's")
        del db, loaded, recv, resp, resp_l, req, psu
        torch.cuda.empty_cache()

        placer = ReceiverDB(params, DebugOprf(), loc_seed=LOC_SEED, device="cuda")
        c_total, sec["place_data"] = synced(lambda: placer.place_data(db_items))
        part, sec["build_partition"] = synced(lambda: placer.build_partition((0, 5)))
        direct = ReceiverDB(params, DebugOprf(), bfv=placer.bfv, loc_seed=LOC_SEED,
                            cache_range=(0, 5))
        direct.set_data(db_items)
        equal = (torch.equal(part.coeff_cache, direct.coeff_cache)
                 and torch.equal(part.ps_const_polys, direct.ps_const_polys))
        res["partition"] = {"caches": c_total, "cache_range": [0, 5],
                            "cache_shape": list(part.coeff_cache.shape),
                            "equals_direct_cache_range_build": equal}
        if not equal:
            raise AssertionError("build_partition != a direct cache_range build")
        del placer, part, direct
    counted = launch_counts()
    launches = {k: counted[k] for k in ("ntt", "ps_inner", "eval_dot")}
    res.update({"launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    emit(res)
    if launches["ntt"] == 0 or launches["ps_inner"] == 0 or launches["eval_dot"]:
        raise AssertionError(f"the DB lifecycle path's launches are wrong: {launches}")
    counted = recorded_launches([calls])
    if counted != launches:
        raise AssertionError(f"recorded calls {counted} != launches {launches}")
    torch.cuda.empty_cache()
    checks = replay_calls([calls], gen, f"{name} DB lifecycle")
    emit({"db_lifecycle_ntt": checks["ntt"], "path": name})
    return {"launches": launches, **checks}


def labeled_path(args, gen, ceilings) -> dict:
    """Phase 11: labeled mode at LABELED_SET (non-PS: K1, K3, G1-G4)."""
    from apsu_tpu_torch.api.parties import Receiver, Sender, _slots_to_item_blocks
    from apsu_tpu_torch.core.bfv import Ciphertext
    from apsu_tpu_torch.core.params import PSUParams
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.hash.items import LocFuncs, decrypt_label, encrypt_label
    from apsu_tpu_torch.mpc.oprf import DebugOprf

    name = LABELED_SET
    params = PSUParams.load_file(str(ROOT / "parameters" / f"{name}.json"))
    tp = params.table_params
    rng = np.random.default_rng(args.seed + 30)
    db_items = rng.integers(0, 1 << 64, size=(DB_ITEMS, 2), dtype=np.uint64)
    nbytes = params.item_bit_count // 8
    plain = rng.integers(0, 256, size=(DB_ITEMS, nbytes), dtype=np.uint8)
    labels = np.zeros((DB_ITEMS, 16), dtype=np.uint8)
    labels[:, :nbytes] = plain
    for i in range(0, DB_ITEMS, ENCRYPT_EVERY):   # the nonce is public: only the ciphertext is stored
        blob = encrypt_label(plain[i].tobytes(), db_items[i: i + 1], LABEL_NONCE)
        labels[i, :nbytes] = np.frombuffer(blob[16:], dtype=np.uint8)
    # the query, each item's DB row beside it (-1: not in the DB); with one
    # location function a cuckoo table holds items of distinct slots only
    first = LocFuncs(tp.table_size, tp.hash_func_count).locations(db_items)[:, 0]
    _, one_a_slot = np.unique(first, return_index=True)
    common = rng.choice(one_a_slot, size=LABELED_COMMON, replace=False)
    cand = rng.integers(0, 1 << 64, size=(64 * LABELED_QUERY, 2), dtype=np.uint64)
    free = ~np.isin(LocFuncs(tp.table_size, tp.hash_func_count).locations(cand)[:, 0],
                    first[common])
    _, fresh = np.unique(LocFuncs(tp.table_size, tp.hash_func_count).locations(cand[free])[:, 0],
                         return_index=True)
    fresh = cand[free][rng.choice(fresh, size=LABELED_QUERY - LABELED_COMMON, replace=False)]
    query = np.concatenate([db_items[common], fresh])
    row = np.concatenate([common, np.full(len(fresh), -1)])
    perm = rng.permutation(len(query))
    query, row = query[perm], row[perm]

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    db = ReceiverDB(params, DebugOprf(), device="cuda")
    stats = db.set_data(db_items, labels=labels)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = launch_counts()
    levels = {"eval_lvl": db.eval_lvl, "labeled_eval_level": db.labeled_eval_level(),
              "unlabeled_eval_level": db.eval_level()}
    emit({"labeled_path": name, "db_items": DB_ITEMS, "query_items": len(query),
          "common_items": LABELED_COMMON, "label_bytes": nbytes,
          "encrypted_labels": len(range(0, DB_ITEMS, ENCRYPT_EVERY)), "set_data_s": build_s,
          "n_caches": stats.n_caches, "max_bin_load": stats.max_bin_load,
          "cache_shape": list(db.coeff_cache.shape), "label_cache_shape": list(db.label_cache.shape),
          "cache_gb": 2 * db.coeff_cache.numel() * 4 / 1e9, **levels,
          "build_launches": build_launches})
    if not levels["eval_lvl"] == levels["labeled_eval_level"] > levels["unlabeled_eval_level"]:
        raise AssertionError(f"labeled build level: {levels}")
    try:
        db.insert_or_assign(db_items[:4])
        raise AssertionError("a labeled DB accepted insert_or_assign")
    except ValueError:
        pass

    snd = Sender(params, DebugOprf(), rng=np.random.default_rng(args.seed + 31), device="cuda")
    req = snd.create_query(query)
    recv = Receiver(params, db, rng=np.random.default_rng(args.seed + 32))
    slot_q = snd.cuckoo.item_index                           # [S] query row or -1
    filled = snd.cuckoo.filled
    in_db = filled & (row[np.maximum(slot_q, 0)] >= 0)
    enc = in_db & (row[np.maximum(slot_q, 0)] % ENCRYPT_EVERY == 0)

    def check(resp, mask):
        """(the matched slots are exactly the DB items', their labels exact,
        the encrypted ones decrypting to theirs; matched slots)."""
        hit = (_slots_to_item_blocks(params, snd.extract_matrix(resp))
               == _slots_to_item_blocks(params, mask)).all(axis=2)       # [C, S]
        got = snd.extract_labels(resp)[hit.argmax(axis=0), np.arange(len(filled))]   # [S, 16]
        matched = hit.any(axis=0) & filled
        ok = np.array_equal(matched, in_db) and np.array_equal(
            got[in_db], labels[row[slot_q[in_db]]])
        ok = ok and all(
            decrypt_label(LABEL_NONCE + got[s, :nbytes].tobytes(), query[slot_q[s]: slot_q[s] + 1])
            == plain[row[slot_q[s]]].tobytes() for s in np.flatnonzero(enc))
        return ok, int(matched.sum())

    calls = kernel_calls()  # the kernel launches of the recorded (eager) query
    runs, launches, per_query = query_runs(recv, req, calls)
    oracles = [check(resp, mask) for resp, mask, *_ in runs]
    control = check(runs[-1][0], runs[0][1])
    warm = [t for _, _, t, how in runs if how == "graph"]
    emit({"labeled_first_query_s": runs[0][2], "labeled_warm_query_s": warm,
          "labeled_warm_best_s": min(warm), "eager_recorded_query_s": runs[-1][2],
          "expected_matches": int(in_db.sum()), "encrypted_label_matches": int(enc.sum()),
          "queries": [how for *_, how in runs],
          "oracle_per_query": [list(o) for o in oracles], "control_other_mask": list(control),
          "launches": launches, "launches_per_query": per_query,
          "result_shape": list(runs[-1][0].results.shape),
          "result_checksums": [int(r.results.to(torch.int64).sum()) for r, *_ in runs],
          "label_checksums": [int(r.label_results.to(torch.int64).sum()) for r, *_ in runs],
          "noise_budget_bits": {   # host big-int CRT over bundle 0, cache 0 of the last query
              name: snd.bfv.noise_budget(Ciphertext(getattr(runs[-1][0], name)[0, 0],
                                                    is_ntt=False, level=db.eval_lvl), snd.sk)
              for name in ("results", "label_results")},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if not all(ok for ok, _ in oracles):
        raise AssertionError("labeled query: a matched item's label is wrong, or a match is")
    if control[0]:
        raise AssertionError("the labels checked against another query's mask passed")
    if (per_query["eval_dot"] != 2 or launches["ntt"] == 0 or launches["ps_inner"]
            or not all(launches[g] for g in GLUE_NAMES)):
        raise AssertionError(f"the labeled path's launches are wrong: {launches}")

    ntt_summary = check_ntt_shapes(calls["ntt"], gen)
    emit({"labeled_ntt_warm_query": ntt_summary, "path": name})
    evals = []
    for (pw_shape, cache, base), which in zip(calls["eval_dot"], ("matching", "label")):
        powers = rand_residues(pw_shape, base.primes, gen)
        evals.append(check_eval_dot(powers, cache, base, f"{name} labeled query ({which} cache)"))
    glue = check_glue_calls(calls["glue"], f"{name} labeled warm query", ceilings)
    progs = programs_path(name, params, db, req, lambda resp, mask: check(resp, mask)[0],
                          args.seed)
    return {"launches": launches, "ntt": ntt_summary, "eval_dot": evals, "glue": glue,
            "launches_per_query": per_query, "programs": progs}


def logged(pattern, text):
    """The last match of ``pattern`` in a process's log ``text``."""
    found = re.findall(pattern, text)
    if not found:
        raise AssertionError(f"no log line matches {pattern!r}")
    return found[-1]


PROGRAM_TURNS = 4   # eager/graphed pairs of phase 15, which goes first alternating
MUTATED_ITEMS = 16  # fresh items phase 15 inserts into an item-built DB
PROGRAM_SUMMARY = ("eager_best_s", "graph_best_s", "capture_ms", "memory_gb",
                   "launches_equal", "launches_traced_in_replay", "profile_graph",
                   "replay_device_ms", "idle_share_of_best_by_replays", "after_mutation",
                   "checksums")


TRACE_TRIES = 3     # traces of a graphed query phase 15 takes before it fails


def traced_kernels(run) -> dict:
    """The hand-written kernels that ``torch.profiler`` traced on the
    device in ``run()``, by ``traced_names``: the second of two steps, the
    first a warm-up (a trace's first step can lose the records of its first
    kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {}

    def ready(prof):
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        got.update({k: sum(e.count for e in events if k in e.key) for k in traced_names()})

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1), on_trace_ready=ready) as prof:
        for _ in range(2):
            run()
            torch.cuda.synchronize()
            prof.step()
    return got


def programs_path(name, params, db, req, exact, seed, fresh=None) -> dict:
    """Phase 15 at one path: ``Receiver.run_query`` through its programs
    (``engine/programs.py``, CUDA graphs) against the same query under
    ``programs.eager()``, on ``db`` and ``req``; ``exact(resp, mask)`` is the
    path's oracle.

    * The programs are dropped, then one eager query and one graphed query
      under one mask seed: the graphed one captures its programs, and its
      extra time over the best replayed query is the capture's cost;
      ``torch.cuda.memory_reserved()`` (and allocated) is read after the
      drop, after the eager query and after the capture.
    * PROGRAM_TURNS pairs in turns (eager, graph, graph, eager, ...), the two
      of a pair under one mask seed: bit for bit equal, both exact by the
      oracle (a control against another mask must fail); the best of each.
    * The launches of one replayed query (the hand-written kernels its
      graphs hold, ``ops/counts.capture``) and of one eager query, equal.
    * One graphed query under ``profile_query`` (busy, idle share,
      kernels), and each program's replay alone timed by CUDA events.
    * The hand-written kernels traced on the device in a graphed query
      (``traced_kernels``) must be the eager query's launches, kernel by
      kernel, in one of TRACE_TRIES traces: the profiler can drop records,
      a graph that launches other kernels differs in every trace.
    * With ``fresh`` items (none of them in the query), an in-place
      mutation: ``db.insert_or_assign(fresh)`` keeps the programs unless
      it grows the cache axis, and the next graphed query (its wall time
      reported) equals an eager one bit for bit and passes the oracle.
    * ``db.strip()``, a mutation that drops the programs and frees no DB
      tensor, and the memory after it."""
    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.engine import programs
    from apsu_tpu_torch.ops import counts
    from apsu_tpu_torch.tools import window_ms

    def query(how, s):
        recv = Receiver(params, db, rng=np.random.default_rng(s))
        with programs.eager() if how == "eager" else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resp = recv.run_query(req)
            torch.cuda.synchronize()
        return resp, recv.last_mask, time.perf_counter() - t0

    def memory():
        torch.cuda.synchronize()
        return {"reserved": torch.cuda.memory_reserved() / 1e9,
                "allocated": torch.cuda.memory_allocated() / 1e9}

    def same(a, b):
        (ra, ma, _), (rb, mb, _) = a, b
        return (np.array_equal(ma, mb) and ra.eval_level == rb.eval_level
                and torch.equal(ra.results, rb.results)
                and (ra.label_results is None) == (rb.label_results is None)
                and (ra.label_results is None or torch.equal(ra.label_results, rb.label_results)))

    programs.drop(db.bfv)
    torch.cuda.empty_cache()   # what earlier phases left cached, too
    mem = {"after_drop": memory()}
    eager0 = query("eager", seed + 300)
    mem["after_eager_query"] = memory()
    first = query("graph", seed + 300)
    mem["after_capture"] = memory()
    identical, oracles, checksums = [same(eager0, first)], [], []
    times = {"eager": [], "graph": []}
    for i in range(PROGRAM_TURNS):
        order = ("eager", "graph") if i % 2 == 0 else ("graph", "eager")
        got = {how: query(how, seed + 301 + i) for how in order}
        for how in order:
            times[how].append(got[how][2])
        identical.append(same(got["eager"], got["graph"]))
        oracles += [bool(exact(*got[how][:2])) for how in order]
        checksums.append(int(got["graph"][0].results.to(torch.int64).sum()))
    control = bool(exact(got["graph"][0], first[1]))   # the first query's mask
    walls = {"first_graph_query_s": first[2], "first_eager_query_s": eager0[2]}
    del got, first, eager0   # no response left to pin its segment below

    names = [name for _, _, name, _ in counters()]
    launches = {}
    for how in ("graph", "eager"):
        before = counts.read()
        query(how, seed + 310)
        launches[how] = {n: v for n, v in zip(names, counts.since(before)) if v}
    prof = profile_query(Receiver(params, db, rng=np.random.default_rng(seed + 311)), req)
    traced_eager = dict.fromkeys(traced_names(), 0)
    for _, _, counter, kernel in counters():
        traced_eager[kernel] += launches["eager"].get(counter, 0)
    traces = []
    while len(traces) < TRACE_TRIES and (not traces or traces[-1] != traced_eager):
        traces.append(traced_kernels(lambda: query("graph", seed + 312)))
    traced = traces[-1]
    replay_ms = {}
    for (kind_key, *_), prog in db.bfv.programs.items():
        replay_ms[kind_key[0]] = min(window_ms(prog.graph.replay)[1] for _ in range(3))
    after_mutation = None
    if fresh is not None:
        kept, c_before = dict(db.bfv.programs), db.coeff_cache.shape[1]
        db.insert_or_assign(fresh)
        grew = db.coeff_cache.shape[1] > c_before
        mutated = query("graph", seed + 320)
        after_mutation = {
            "inserted": len(fresh), "grew_cache_axis": grew,
            "programs_kept": len(db.bfv.programs) == len(kept) and all(
                db.bfv.programs.get(k) is prog for k, prog in kept.items()),
            "first_graph_query_s": mutated[2]}
        eager_m = query("eager", seed + 320)
        after_mutation.update(eager_query_s=eager_m[2], bit_identical=same(mutated, eager_m),
                              oracle_exact=bool(exact(*mutated[:2])))
        del mutated, eager_m
    db.strip()   # drops the programs and empties the cache (programs.drop)
    mem["after_strip_drop"] = memory()
    best = {how: min(t) for how, t in times.items()}
    res = {"programs_path": name, "gpu": GPU, "turns": PROGRAM_TURNS,
           "eager_s": times["eager"], "graph_s": times["graph"],
           "eager_best_s": best["eager"], "graph_best_s": best["graph"],
           **walls, "capture_ms": (walls["first_graph_query_s"] - best["graph"]) * 1e3,
           "bit_identical": identical, "oracle_exact": oracles, "control_other_mask": control,
           "checksums": checksums, "launches_per_replayed_query": launches["graph"],
           "launches_per_eager_query": launches["eager"],
           "launches_traced_in_replay": traced, "launches_traced_expected": traced_eager,
           "trace_tries": len(traces),
           "launches_equal": launches["graph"] == launches["eager"] and traced == traced_eager,
           "after_mutation": after_mutation,
           "profile_graph": {k: prof[k] for k in ("profile_wall_ms", "device_busy_ms",
                                                  "device_idle_share", "kernels_launched",
                                                  "host_ms_by_span")},
           "idle_share_of_best_by_replays": 1 - sum(replay_ms.values()) / 1e3 / best["graph"],
           "replay_device_ms": replay_ms, "memory_gb": mem}
    emit(res)
    if not all(identical):
        raise AssertionError(f"a graphed response differs from the eager one ({name})")
    if not all(oracles) or control:
        raise AssertionError(f"the programs' oracle failed, or its control passed ({name})")
    if not res["launches_equal"]:
        raise AssertionError(f"a replayed query's launches (counted or traced) differ from "
                             f"an eager one's ({name})")
    if after_mutation is not None and not (
            after_mutation["bit_identical"] and after_mutation["oracle_exact"]
            and after_mutation["programs_kept"] != after_mutation["grew_cache_axis"]):
        raise AssertionError(f"the query after an in-place mutation is wrong ({name}): "
                             f"{after_mutation}")
    if db.bfv.programs:
        raise AssertionError(f"strip() left programs on the context ({name})")
    return res


def sharded_path(name, params, db, req, exact, seed, gen, ceilings) -> dict:
    """Phase 12 at one set: ``ShardedReceiver`` over a mesh of SHARDS[0]
    shard (the one-card deployment) and of SHARDS[1] shards on the one card,
    against ``Receiver.run_query`` on the same DB and request.  Each sharded
    query draws its mask from the seed of a direct one and must give the
    direct response bit for bit and pass the set's oracle ``exact(resp,
    mask)``; a response read against another query's mask must fail it.  The
    direct and the 1-shard queries run in turns (direct, sharded, sharded,
    direct, ...), timed, the direct one under ``programs.eager()`` as the
    sharded one runs; each sharded query's launches are counted from 0,
    and every kernel call of the second 5-shard query is held against its
    plain version (the glue kernels' also timed, ``check_glue_calls``).  The
    5-shard mesh runs its row ranges one after another on one card: its time
    is a check of the partition, not a deployment's."""
    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.engine import programs
    from apsu_tpu_torch.parallel.mesh import make_mesh
    from apsu_tpu_torch.parallel.runtime import ShardedReceiver

    meshes = {n: make_mesh(devices=[db.device] * n) for n in SHARDS}
    rows = int(db.coeff_cache.shape[0] * db.coeff_cache.shape[1])
    calls = kernel_calls()
    launches = {n: [] for n in SHARDS}

    def query(n, s, record=False):
        rng = np.random.default_rng(s)
        recv = (Receiver(params, db, rng=rng) if n is None
                else ShardedReceiver(params, db, meshes[n], rng=rng))
        reset_launches()
        # the direct query runs eagerly, as the sharded one does (the mesh
        # path has no programs yet), so the overhead compares like with like
        with recording_kernels(calls, on=record), \
                programs.eager() if n is None else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            resp = recv.run_query(req)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if n is not None:
            launches[n].append(launch_counts())
        return resp, recv.last_mask, wall

    times = {"direct": [], SHARDS[0]: [], SHARDS[1]: []}
    identical, oracles, masks = [], [], []
    for i in range(WARM + 1):
        s = seed + 100 + i
        got = {}
        for who in ((None, SHARDS[0]) if i % 2 == 0 else (SHARDS[0], None)):
            got[who] = query(who, s)
        runs = [(SHARDS[0], got[SHARDS[0]])]
        if i < 2:
            runs.append((SHARDS[1], query(SHARDS[1], s, record=i == 1)))
        want, want_mask, t_direct = got[None]
        times["direct"].append(t_direct)
        masks.append(want_mask)
        for n, (resp, mask, wall) in runs:
            times[n].append(wall)
            identical.append(resp.eval_level == want.eval_level and np.array_equal(mask, want_mask)
                             and torch.equal(resp.results, want.results))
            oracles.append(exact(resp, mask))
    control = exact(got[SHARDS[0]][0], masks[0])   # the last response, the first mask
    best = {k: min(v[1:] if len(v) > 1 else v) for k, v in times.items()}
    res = {"sharded_path": name, "gpu": GPU, "shards": list(SHARDS),
           "rows": rows, "row_ranges": {n: meshes[n].row_ranges(rows) for n in SHARDS},
           "direct_warm_s": times["direct"], f"sharded_{SHARDS[0]}dev_warm_s": times[SHARDS[0]],
           f"sharded_{SHARDS[1]}shard_s": times[SHARDS[1]],
           "direct_best_s": best["direct"], f"sharded_{SHARDS[0]}dev_best_s": best[SHARDS[0]],
           f"sharded_{SHARDS[0]}dev_overhead_pct":
               (best[SHARDS[0]] - best["direct"]) / best["direct"] * 100,
           "note": f"the {SHARDS[1]}-shard mesh runs its ranges in turn on one card: a check of "
                   "the partition, not a deployment time",
           "bit_identical": identical, "oracle_exact": oracles, "control_other_mask": control,
           "launches_per_query": launches}
    emit(res)
    if not all(identical):
        raise AssertionError(f"a sharded response differs from the direct one ({name})")
    if not all(oracles) or control:
        raise AssertionError(f"the sharded oracle failed, or its control passed ({name})")
    ps = db.ps_const_polys is not None
    kernel, other = ("ps_inner", "eval_dot") if ps else ("eval_dot", "ps_inner")
    for n in SHARDS:   # at least one launch of the evaluation's kernel a non-empty shard
        busy = sum(r1 > r0 for r0, r1 in meshes[n].row_ranges(rows))
        for c in launches[n]:
            if (c["ntt"] == 0 or c[kernel] < busy or c[other]
                    or not all(c[g] for g in GLUE_NAMES)):
                raise AssertionError(f"{n}-shard launches are wrong ({name}): {c}")

    out = {"launches": {k: sum(c[k] for n in SHARDS for c in launches[n])
                        for k in ("ntt", "ps_inner", "eval_dot", *GLUE_NAMES)},
           "ntt": check_ntt_shapes(calls["ntt"], gen), kernel: []}
    emit({"sharded_ntt": out["ntt"], "path": name, "shards": SHARDS[1]})
    label = f"{name} {SHARDS[1]}-shard query (DB cache rows)"
    for first, cache, base in calls[kernel]:
        x = rand_residues(first, base.primes, gen)
        out[kernel].append(check_ps_inner(x, cache, base, label) if ps
                           else check_eval_dot(x, cache, base, label))
    out["glue"] = check_glue_calls(calls["glue"], f"{name} {SHARDS[1]}-shard query", ceilings)
    return out


def grid_path(args, gen) -> dict:
    """Phase 13: the DB party as a GRID_WORKERS-worker grid through the four
    CLIs at 1M-2048-com on the card: ``worker_cli`` processes on ``--port 0``
    (each logs the port it bound), bundles split in two and caches in
    ``GRID_CACHE_PARTS`` ranges of the global C, one ``receiver_cli
    --workers ... --cache-parts`` coordinator serving two queries and one
    ``sender_cli --peqt osn`` with two query files (KKRT, the second through
    OP_REBIND, which every worker rebinds to).  Each union.csv against the
    set algebra of the CSVs, with a control (a query never sent must not be
    in it); each worker's build and rebind time, peak device memory, link
    bytes and its debug line that the consumed cache went before the rebind
    built the next; the coordinator's ``dist_*`` split.  Every process runs
    under ``cli_child``, and the kernels are held against their plain
    versions at every recorded call."""
    name = "1M-2048-com"
    rng = np.random.default_rng(args.seed + 13)
    db = [f"db-item-{i}" for i in range(DB_ITEMS)]
    picks = rng.choice(DB_ITEMS, size=2 * COMMON_ITEMS, replace=False)
    queries = [[f"grid{k}-item-{i}" for i in range(QUERY_ITEMS - COMMON_ITEMS)]
               + [db[j] for j in picks[k * COMMON_ITEMS:(k + 1) * COMMON_ITEMS]]
               for k in range(2)]
    unsent = "grid2-item-0"
    params_file = str(ROOT / "parameters" / f"{name}.json")
    procs = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli-", dir=ROOT) as tmp:
        tmp = Path(tmp)
        for fname, rows in [("db.csv", db), ("query0.csv", queries[0]),
                            ("query1.csv", queries[1])]:
            (tmp / fname).write_text("".join(r + "\n" for r in rows))
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        common = ["--params", params_file, "--bind", "127.0.0.1", "--log-level", "debug",
                  "--device", CLI_DEVICE]

        def spawn(module, record, *argv):
            p = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--cli-child", str(tmp / record),
                 f"apsu_tpu_torch.cli.{module}", *argv],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
            lines = []
            reader = threading.Thread(target=lambda: lines.extend(p.stderr), daemon=True)
            reader.start()
            procs.append((p, lines, reader))
            return p, lines

        def wait_log(pattern, p, lines, t0):
            while True:
                found = re.search(pattern, "".join(lines))
                if found:
                    return found
                if p.poll() is not None or time.perf_counter() - t0 > CLI_TIMEOUT:
                    raise RuntimeError(f"no {pattern!r} in the log:\n" + "".join(lines)[-3000:])
                time.sleep(0.2)

        t0 = time.perf_counter()
        try:
            workers = [spawn("worker_cli", f"worker{i}_calls.json", *common, "--port", "0")
                       for i in range(GRID_WORKERS)]
            ports = [int(wait_log(r"worker listening on 127\.0\.0\.1:(\d+)", p, lines, t0)[1])
                     for p, lines in workers]
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = str(s.getsockname()[1])
            recv, recv_lines = spawn(
                "receiver_cli", "receiver_calls.json", *common, "--db-file",
                str(tmp / "db.csv"), "--out", str(tmp / "union.csv"), "--serve", "2",
                "--seed", str(args.seed + 1), "--port", port,
                "--workers", ",".join(f"127.0.0.1:{q}" for q in ports),
                "--cache-parts", str(GRID_CACHE_PARTS))
            wait_log(r"listening on 127\.0\.0\.1:" + port, recv, recv_lines, t0)
            send, send_lines = spawn(
                "sender_cli", "sender_calls.json", "--query-file", str(tmp / "query0.csv"),
                str(tmp / "query1.csv"), "--host", "127.0.0.1", "--port", port, "--peqt", "osn",
                "--seed", str(args.seed + 2), "--log-level", "debug", "--device", CLI_DEVICE)
            rcs = [p.wait(timeout=CLI_TIMEOUT) for p, _, _ in procs]
        finally:
            for p, _, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        for _, _, reader in procs:
            reader.join(30)
        logs = ["".join(lines) for _, lines, _ in procs]
        if any(rcs):
            raise RuntimeError(f"the grid's CLIs failed: rcs {rcs}\n"
                               + "\n".join(log[-2000:] for log in logs))
        union = set((tmp / "union.csv").read_text().split())
        recorded = [json.loads((tmp / f).read_text()) for f in
                    [f"worker{i}_calls.json" for i in range(GRID_WORKERS)]
                    + ["receiver_calls.json", "sender_calls.json"]]

    wlogs, recv_log = logs[:GRID_WORKERS], logs[GRID_WORKERS]
    want = set(db) | set(queries[0]) | set(queries[1])
    fresh = 2 * (QUERY_ITEMS - COMMON_ITEMS)
    new = int(logged(r"\(2 queries, received (\d+) new\)", recv_log))
    timings = ast.literal_eval(logged(r"timings: (\{.*\})", recv_log))
    launches_by = [json.loads(logged(r"kernel launches: (\{.*\})", log)) for log in logs]
    launches = {k: sum(x[k] for x in launches_by) for k in launches_by[0]}
    rebind_mem = [dict(zip(("before", "after_release", "after_rebind", "cache"), map(float, logged(
        r"worker rebind: device memory allocated ([\d.]+) GB before, ([\d.]+) GB after "
        r"releasing the consumed cache, ([\d.]+) GB after the rebind \(cache ([\d.]+) GB\)",
        log)))) for log in wlogs]
    res = {"grid_path": name, "gpu": GPU, "processes": [
               f"{GRID_WORKERS} x worker_cli --port 0",
               f"receiver_cli --serve 2 --cache-parts {GRID_CACHE_PARTS} --workers ...",
               "sender_cli --peqt osn (2 query files)"],
           "worker_ports": ports, "db_items": len(db),
           "query_items": [len(q) for q in queries], "common_items_each": COMMON_ITEMS,
           "wall_s": wall, "union": len(union), "expected_union": len(want),
           "union_exact": union == want, "control_unsent_in_union": unsent in union,
           "received_new": new, "expected_new": fresh,
           "worker_build_s": timings.get("worker_build_s"),
           "worker_rebind_s": timings.get("worker_rebind_s"),
           "dist_s": {k: timings.get(k) for k in ("dist_scatter_s", "dist_wait_s",
                                                  "dist_concat_s")},
           "coordinator_timings": timings,
           "link_bytes": [[int(x) for x in logged(
               r"worker done \(sent (\d+) bytes, received (\d+)\)", log)] for log in wlogs],
           "worker_peak_mem_gb": [float(logged(r"peak device memory: ([\d.]+) GB", log))
                                  for log in wlogs],
           "worker_rebind_mem_gb": rebind_mem,
           "launches_by_process": launches_by,
           "ot_flavors_coordinator": ot_flavors(recv_log.splitlines())}
    emit(res)
    if union != want or new != fresh:
        raise AssertionError("the grid's union.csv is not the union of the CSVs")
    if unsent in union:
        raise AssertionError("the control (a query item never sent) is in the union")
    if "rebind" not in timings or len(timings.get("worker_rebind_s") or []) != GRID_WORKERS:
        raise AssertionError("the second query did not rebind every worker")
    for m in rebind_mem:
        if m["before"] - m["after_release"] < m["cache"] - 1e-3:
            raise AssertionError(f"a worker's rebind did not free the consumed cache first: {m}")
    if any(x["ps_inner"] == 0 for x in launches_by[:GRID_WORKERS]) or launches["eval_dot"]:
        raise AssertionError(f"the grid's launches are wrong: {launches_by}")
    counted = recorded_launches(recorded)
    if counted != launches:
        raise AssertionError(f"recorded calls {counted} != logged launches {launches}")
    checks = replay_calls(recorded, gen, f"{name} worker grid")
    emit({"grid_ntt": checks["ntt"], "path": name})
    return {"launches": launches, **checks}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-child"]:   # the CLI processes of phases 9 and 13
        sys.exit(cli_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())
