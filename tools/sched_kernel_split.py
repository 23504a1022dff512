#!/usr/bin/env python3
"""Time the scheduler kernels at the path shapes, in turns, and split each
slot's (or Best-Fit job's) time by phase.

    python3 tools/sched_kernel_split.py --src DIR[:TAG] [--src DIR2:TAG2 ...]
        [--which bfjs,vqs_bf,vqs_bf16,bfjs_mr,vqs,vqs16,best_fit,best_fit_g1,
         best_fit_g1024] [--turns 2] [--prof]

Each DIR holds ``bfjs.cu``, ``vqs_bf.cu``, ``bfjs_mr.cu``, ``vqs.cu`` and
``best_fit.cu`` with the headers they include: the port's ``src/repro_torch/kernels/csrc``,
or an older revision's copy (``git show REV:src/repro_torch/kernels/csrc/
bfjs.cu > DIR/bfjs.cu`` and so on, into a directory that ``.gitignore``
lists).  The script builds every source with nvcc into
``src/repro_torch/kernels/_build/split/``, makes the path streams on the
card (128 members x 1000 servers x 1000 slots, sizes U[0.1, 0.9] on every
resource, mu = 0.01, K = 16, A_max = 48, W = 52; bfjs: Qcap = 4096, lam =
17; vqs_bf and vqs: J = 4, Qcap = 1024, lam = 12, and lam = 16 under
``vqs_bf16`` and ``vqs16``, vqs with drain 16; bfjs_mr: R = 2, Qcap = 1024,
lam = 16), times each source's kernel with CUDA events (a warm-up launch,
then the mean of 3) in turns — the sources in order, then in reverse — and
checks that all sources give equal trajectories.  The ``best_fit`` cells
are the best-fit path's shape (128 problems x 1000 servers x 4096 jobs,
residuals U[0, 1], sizes U[0.01, 0.3], numpy seed 0) and the same law at
1 and 1024 problems, each source timed as the mean of 10 launches.

``--prof`` also builds a copy of each source with clock64() counters at
its phase boundaries (written beside the builds; the sources are not
touched) and prints, per slot (per job for best_fit) and averaged over the
members, the cycles of each phase as the block's thread 0 sees them, the
cycles the second warp works and waits (the two-warp designs), and counts
of steps (best_fit: scans, rejections without a scan, recomputed maxima).  The counters
add a few per cent to the kernel's time.  It needs a CUDA device and
nvcc, and exits non-zero without them.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "src" / "repro_torch" / "kernels" / "_build" / "split"
P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
NCOUNT = 32  # counters a block

CELLS = {  # cell: (kernel, shape, lam)
    "bfjs": ("bfjs", dict(L=1000, K=16, Qcap=4096, A=48, W=52), 17.0),
    "vqs_bf": ("vqs_bf", dict(J=4, L=1000, K=16, Qcap=1024, A=48, W=52), 12.0),
    "vqs_bf16": ("vqs_bf", dict(J=4, L=1000, K=16, Qcap=1024, A=48, W=52), 16.0),
    "bfjs_mr": ("bfjs_mr", dict(R=2, L=1000, K=16, Qcap=1024, A=48, W=52), 16.0),
    "vqs": ("vqs", dict(J=4, L=1000, K=16, Qcap=1024, A=48, W=52, P=16), 12.0),
    "vqs16": ("vqs", dict(J=4, L=1000, K=16, Qcap=1024, A=48, W=52, P=16), 16.0),
    "best_fit": ("best_fit", dict(G=128, L=1000, N=4096), None),
    "best_fit_g1": ("best_fit", dict(G=1, L=1000, N=4096), None),
    "best_fit_g1024": ("best_fit", dict(G=1024, L=1000, N=4096), None),
}

HEAD = ('__device__ long long g_prof[4096 * 32];\n'
        '#define PROF(i) if (threadIdx.x == 0) { long long now_ = clock64(); '
        'pacc[i] += now_ - plast; plast = now_; }\n'
        '#define CNT(i, v) if (threadIdx.x == 0) { pacc[i] += (v); }\n')
TAIL = ('\nextern "C" int prof_read(long long* host, int n) {\n'
        '  return cudaMemcpyFromSymbol(host, g_prof, n * sizeof(long long));\n}\n'
        'extern "C" int prof_clear() {\n  void* p = nullptr;\n'
        '  const cudaError_t e = cudaGetSymbolAddress(&p, g_prof);\n'
        '  return e ? e : cudaMemset(p, 0, sizeof(g_prof));\n}\n')
START = '  long long pacc[32] = {0}; long long plast = clock64(); const long long pstart = plast;\n'
STORE = ('    pacc[31] = clock64() - pstart;\n'
         '    for (int i = 0; i < 32; ++i) if (i < 24 || i == 31) g_prof[g * 32 + i] = pacc[i];\n')

# Counter names by index: phases (cycles of thread 0), then counts
# ("#": per slot), then the second warp's work and wait; index 31 is the
# block's total.
NAMES = {
    ("bfjs", "block"): {0: "departures", 1: "enqueue", 2: "qmin", 3: "cur", 4: "bfs_arg",
                        5: "bfj_arg", 6: "place", 7: "saturation", 8: "occupancy+end",
                        20: "#steps", 21: "#bfs_steps", 22: "#bfj_steps"},
    ("bfjs", "warp"): {0: "departures", 1: "enqueue", 2: "qmin+cur", 3: "bfs_arg",
                       4: "bfj_arg", 5: "place", 6: "saturation", 7: "snapshot+out",
                       8: "barrier_wait", 20: "#steps", 21: "#bfs_steps", 22: "#bfj_steps",
                       24: "warp1_work", 25: "warp1_wait"},
    ("vqs_bf", "block"): {0: "departures", 1: "classify+enqueue", 2: "visit",
                          3: "minima+config", 4: "pass1", 5: "pass2", 6: "pop_scan",
                          7: "pop_place", 8: "bfj_pass", 9: "write_slot", 10: "any_pending",
                          20: "#steps", 21: "#pops"},
    ("vqs_bf", "warp"): {0: "merge", 1: "enqueue", 2: "departures+visit", 3: "rescans",
                         4: "pass1", 5: "config", 6: "pass2", 7: "stage+pop_scan",
                         8: "pop_place", 9: "bfj_pass+out", 10: "barrier_wait",
                         20: "#steps", 21: "#new_placers", 22: "#pending", 24: "warp1_work",
                         25: "warp1_wait"},
    ("bfjs_mr", "block"): {0: "departures", 1: "enqueue", 2: "freed_list", 3: "bfs_arg",
                           4: "bfs_place", 5: "bfj_arg", 6: "bfj_place", 7: "saturation",
                           8: "occupancy+out", 20: "#steps", 21: "#bfs_tests",
                           22: "#bfj_steps", 23: "#bfs_places"},
    ("vqs", "block"): {0: "departures", 1: "classify+enqueue", 2: "visit", 3: "heads+mw_row",
                       4: "pass1", 5: "pass2", 6: "serve", 7: "any_pending", 8: "write_slot",
                       20: "#steps", 21: "#serves"},
    ("bfjs_mr", "warp"): {0: "merge+departures", 1: "enqueue", 2: "minima+prefilter",
                          3: "bfs_test", 4: "bfs_walk+place", 5: "bfj_scan", 6: "bfj_place",
                          7: "saturation", 8: "outputs", 9: "barrier_wait", 19: "#bfj_scans",
                          20: "#steps", 21: "#bfs_tests", 22: "#bfj_steps", 23: "#bfs_places",
                          24: "warp1_work", 25: "warp1_wait"},
    ("best_fit", "block"): {0: "size_load", 1: "scan", 2: "block_arg", 3: "update+sync",
                            20: "#scans"},
    ("best_fit", "warp"): {0: "fetch+test", 1: "scan", 2: "reduce+exchange", 3: "update",
                           4: "tail", 20: "#scans", 21: "#no-scan rejects",
                           26: "#max_recomputes"},
    ("vqs", "warp"): {0: "merge+arrivals", 1: "departures+visit", 2: "config", 3: "walk",
                      4: "prefix_fit", 5: "place", 6: "outputs", 7: "barrier_wait",
                      20: "#steps", 21: "#serves", 22: "#pending",
                      24: "warp1_work", 25: "warp1_wait"},
}

# The two-warp designs' stream warps: cycles of work and of waiting.
STREAM_BFJS_MR = ('    for (int t = 0; t < T; ++t) {\n      if (t + 1 < T) fetch(t + 1);\n      repro::named_barrier(kDepartBarrier, kPairThreads);\n      vqsk::recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);\n      repro::named_barrier(kSlotBarrier, kPairThreads);\n    }\n    return;', '    long long hw_ = 0, hb_ = 0;\n    for (int t = 0; t < T; ++t) {\n      long long h0_ = clock64();\n      if (t + 1 < T) fetch(t + 1);\n      long long h1_ = clock64();\n      repro::named_barrier(kDepartBarrier, kPairThreads);\n      long long h2_ = clock64();\n      vqsk::recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);\n      long long h3_ = clock64();\n      repro::named_barrier(kSlotBarrier, kPairThreads);\n      hw_ += (h1_ - h0_) + (h3_ - h2_); hb_ += (h2_ - h1_) + (clock64() - h3_);\n    }\n    if (lane == 0) { g_prof[g * 32 + 24] = hw_; g_prof[g * 32 + 25] = hb_; }\n    return;')
STREAM_VQS = ('    for (int t = 0; t < T; ++t) {\n      if (t + 1 < T) load_slot(t + 1);\n      repro::named_barrier(kDepartBarrier, kVqsThreads);\n      recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);\n      repro::named_barrier(kSlotBarrier, kVqsThreads);\n    }\n    return;', '    long long hw_ = 0, hb_ = 0;\n    for (int t = 0; t < T; ++t) {\n      long long h0_ = clock64();\n      if (t + 1 < T) load_slot(t + 1);\n      long long h1_ = clock64();\n      repro::named_barrier(kDepartBarrier, kVqsThreads);\n      long long h2_ = clock64();\n      recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);\n      long long h3_ = clock64();\n      repro::named_barrier(kSlotBarrier, kVqsThreads);\n      hw_ += (h1_ - h0_) + (h3_ - h2_); hb_ += (h2_ - h1_) + (clock64() - h3_);\n    }\n    if (lane == 0) { g_prof[g * 32 + 24] = hw_; g_prof[g * 32 + 25] = hb_; }\n    return;')

# (anchor, replacement) pairs: each anchor must occur exactly once.
PATCHES = {
    ("best_fit", "block"): [
        ('  for (int l = threadIdx.x; l < L; l += blockDim.x) r[l] = resid[l];\n  __syncthreads();\n',
         '  for (int l = threadIdx.x; l < L; l += blockDim.x) r[l] = resid[l];\n  __syncthreads();\n'
         + START),
        ('    const float size = sizes[j];\n', '    const float size = sizes[j];\n    PROF(0)\n'),
        ('    repro::block_arg<true>(bv, bi, redf, redi);\n',
         '    PROF(1)\n    repro::block_arg<true>(bv, bi, redf, redi);\n    PROF(2)\n'),
        ('    __syncthreads();\n  }\n  for (int l = threadIdx.x; l < L; l += blockDim.x) out_resid[l] = r[l];',
         '    __syncthreads();\n    PROF(3) CNT(20, 1)\n  }\n  if (threadIdx.x == 0) {\n' + STORE
         + '  }\n  for (int l = threadIdx.x; l < L; l += blockDim.x) out_resid[l] = r[l];'),
    ],
    ("best_fit", "warp"): [
        ('  int xp = 0;  // exchanges made: picks the buffer\n',
         '  int xp = 0;  // exchanges made: picks the buffer\n' + START),
        ('    if (size > 0.f && ks <= gmax) {  // else nothing fits: rejected without a scan\n',
         '    PROF(0) CNT(21, !(size > 0.f && ks <= gmax))\n'
         '    if (size > 0.f && ks <= gmax) {  // else nothing fits: rejected without a scan\n'
         '      CNT(20, 1)\n'),
        ('      unsigned bd = __reduce_min_sync(repro::kFullMask, d);\n',
         '      PROF(1)\n      unsigned bd = __reduce_min_sync(repro::kFullMask, d);\n'),
        ('      const unsigned bk = bd + ks;  // the tightest key\n',
         '      PROF(2)\n      const unsigned bk = bd + ks;  // the tightest key\n'),
        ('          if (bk == wmax) {\n',
         '          if (bk == wmax) {\n            if (lane == 0) atomicAdd('
         'reinterpret_cast<unsigned long long*>(&g_prof[g * 32 + 26]), 1ull);\n'),
        ('            wmax = __reduce_max_sync(repro::kFullMask, m);\n          }\n        }\n      }\n'
         '    }\n',
         '            wmax = __reduce_max_sync(repro::kFullMask, m);\n          }\n        }\n      }\n'
         '      PROF(3)\n    }\n'),
        ('    size = size_n;\n  }\n',
         '    size = size_n;\n    PROF(4)\n  }\n  if (threadIdx.x == 0) {\n' + STORE + '  }\n'),
    ],
    ("bfjs", "block"): [
        ('  int q_cnt = 0, dropped = 0, n_trunc = 0;\n',
         '  int q_cnt = 0, dropped = 0, n_trunc = 0;\n' + START),
        ('    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n',
         '    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n    PROF(0)\n'),
        ('    dropped += n_t - n_landed;\n', '    PROF(1)\n    dropped += n_t - n_landed;\n'),
        ('      const float qmin = repro::block_reduce(m, redf, repro::MinF());\n      int c = L;',
         '      const float qmin = repro::block_reduce(m, redf, repro::MinF());\n      PROF(2)\n'
         '      int c = L;'),
        ('      const int cur = repro::block_reduce(c, redi, repro::MinI());\n',
         '      const int cur = repro::block_reduce(c, redi, repro::MinI());\n      PROF(3)\n'),
        ('      if (cur == L && a_ptr >= n_landed) { done = true; break; }\n',
         '      if (cur == L && a_ptr >= n_landed) { done = true; break; }\n      CNT(20, 1)\n'),
        ('        repro::block_arg<false>(bv, bi, redf, redi);\n',
         '        repro::block_arg<false>(bv, bi, redf, redi);\n        PROF(4) CNT(21, 1)\n'),
        ('        const int a = a_ptr++;\n', '        const int a = a_ptr++;\n        CNT(22, 1)\n'),
        ('          repro::block_arg<true>(bv, bi, redf, redi);\n',
         '          repro::block_arg<true>(bv, bi, redf, redi);\n          PROF(5)\n'),
        ('        --q_cnt;\n        __syncthreads();\n      }\n',
         '        --q_cnt;\n        __syncthreads();\n        PROF(6)\n      }\n'),
        ('    if (!done) {\n', '    PROF(6)\n    if (!done) {\n'),
        ('      n_trunc += pend;\n    }\n', '      n_trunc += pend;\n    }\n    PROF(7)\n'),
        ('    __syncthreads();\n  }\n  if (tid == 0) {\n    dropped_out[g] = dropped;',
         '    __syncthreads();\n    PROF(8)\n  }\n  if (tid == 0) {\n' + STORE
         + '    dropped_out[g] = dropped;'),
    ],
    ("bfjs", "warp"): [
        ('    repro::named_barrier(kSlotBarrier, kThreads);\n    for (int t = 0; t < T; ++t) {\n'
         '      if (t + 1 < T) {\n',
         '    repro::named_barrier(kSlotBarrier, kThreads);\n    long long hw_ = 0, hb_ = 0;\n'
         '    for (int t = 0; t < T; ++t) {\n      long long h0_ = clock64();\n'
         '      if (t + 1 < T) {\n'),
        ('        occ[t - 1] = chain_sum32(snap + ((t - 1) & 1) * LP, LP);\n      }\n'
         '      repro::named_barrier(kSlotBarrier, kThreads);\n    }\n',
         '        occ[t - 1] = chain_sum32(snap + ((t - 1) & 1) * LP, LP);\n      }\n'
         '      long long h1_ = clock64();\n      repro::named_barrier(kSlotBarrier, kThreads);\n'
         '      hw_ += h1_ - h0_; hb_ += clock64() - h1_;\n    }\n'
         '    if (lane == 0) { g_prof[g * 32 + 24] = hw_; g_prof[g * 32 + 25] = hb_; }\n'),
        ('  bool qmin_stale = false;\n', '  bool qmin_stale = false;\n' + START),
        ('    bool bfs_live = __any_sync(repro::kFullMask, any_freed);\n',
         '    bool bfs_live = __any_sync(repro::kFullMask, any_freed);\n    PROF(0)\n'),
        ('    q_cnt += n_landed;\n', '    q_cnt += n_landed;\n    PROF(1)\n'),
        ('        bfs_live = cur < L;\n      }\n', '        bfs_live = cur < L;\n      }\n      PROF(2)\n'),
        ('      if (cur == L && a_ptr >= n_landed) { done = true; break; }\n',
         '      if (cur == L && a_ptr >= n_landed) { done = true; break; }\n      CNT(20, 1)\n'),
        ('        const int qi = repro::warp_argmax_key(bk, bi, best);\n',
         '        const int qi = repro::warp_argmax_key(bk, bi, best);\n        PROF(3) CNT(21, 1)\n'),
        ('          const int s = repro::warp_argmin_key(bk, bi, best);\n',
         '          const int s = repro::warp_argmin_key(bk, bi, best);\n          PROF(4)\n'),
        ('          if (best != repro::kNoMinKey) place(s, sz, pos, sb_bfj[a]);\n        }\n      }\n',
         '          if (best != repro::kNoMinKey) place(s, sz, pos, sb_bfj[a]);\n        }\n'
         '        CNT(22, 1)\n      }\n      PROF(5)\n'),
        ('    // saturation check: a placement', '    PROF(5)\n    // saturation check: a placement'),
        ('      n_trunc += __any_sync(repro::kFullMask, pend) ? 1 : 0;\n    }\n',
         '      n_trunc += __any_sync(repro::kFullMask, pend) ? 1 : 0;\n    }\n    PROF(6)\n'),
        ('      ndep_out[t] = n_dep;\n    }\n    repro::named_barrier(kSlotBarrier, kThreads);\n  }\n',
         '      ndep_out[t] = n_dep;\n    }\n    PROF(7)\n'
         '    repro::named_barrier(kSlotBarrier, kThreads);\n    PROF(8)\n  }\n'),
        ('  if (lane == 0) {\n    dropped_out[g] = dropped;',
         '  if (lane == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
    ("vqs_bf", "block"): [
        ('  int dropped = 0, n_trunc = 0, seq_ctr = 0;\n',
         '  int dropped = 0, n_trunc = 0, seq_ctr = 0;\n' + START),
        ('    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n',
         '    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n    PROF(0)\n'),
        ('    // 3. visit set\n', '    PROF(1)\n    // 3. visit set\n'),
        ('    bool done = false;\n    for (int step = 0; step <= W; ++step) {\n',
         '    PROF(2)\n    bool done = false;\n    for (int step = 0; step <= W; ++step) {\n'),
        ('      __syncthreads();\n      const unsigned hx = static_cast<unsigned>(bc[kHx]);',
         '      __syncthreads();\n      PROF(3)\n      const unsigned hx = static_cast<unsigned>(bc[kHx]);'),
        ('      key = repro::block_reduce(key, redi, repro::MinI());\n',
         '      key = repro::block_reduce(key, redi, repro::MinI());\n      PROF(4)\n'),
        ('      const int placer = key;\n', '      const int placer = key;\n      CNT(20, 1)\n'),
        ('      __syncthreads();\n      if (placer == L) continue;',
         '      __syncthreads();\n      PROF(5)\n      if (placer == L) continue;'),
        ('      __syncthreads();\n      // ... and the largest wins',
         '      __syncthreads();\n      PROF(6)\n      // ... and the largest wins'),
        ('      __syncthreads();\n    }\n    // step bound hit',
         '      __syncthreads();\n      PROF(7) CNT(21, 1)\n    }\n    // step bound hit'),
        ('    if (!done) n_trunc += any_pending(flags, L, redi);\n',
         '    if (!done) n_trunc += any_pending(flags, L, redi);\n    PROF(10)\n'),
        ('    write_slot(occ, qcnt, L, nvq, n_dep, redi, qlen + t, occ_out + t, ndep_out + t);\n',
         '    PROF(8)\n    write_slot(occ, qcnt, L, nvq, n_dep, redi, qlen + t, occ_out + t, ndep_out + t);\n'
         '    __syncthreads();\n    PROF(9)\n'),
        ('  if (tid == 0) {\n    dropped_out[g] = dropped;',
         '  if (tid == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
    ("vqs_bf", "warp"): [
        (('    for (int t = 0; t < T; ++t) {\n      if (t + 1 < T) classify_slot(t + 1);\n'
          '      repro::named_barrier(kDepartBarrier, kBfThreads);\n      recompute(t);\n'
          '      repro::named_barrier(kSlotBarrier, kBfThreads);\n    }\n    return;',
          '    for (int t = 0; t < T; ++t) {\n      if (t + 1 < T) load_slot(t + 1);\n'
          '      repro::named_barrier(kDepartBarrier, kBfThreads);\n'
          '      recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);\n'
          '      repro::named_barrier(kSlotBarrier, kBfThreads);\n    }\n    return;'),
         '    long long hw_ = 0, hb_ = 0;\n    for (int t = 0; t < T; ++t) {\n'
         '      long long h0_ = clock64();\n      if (t + 1 < T) LOAD_SLOT(t + 1);\n'
         '      long long h1_ = clock64();\n      repro::named_barrier(kDepartBarrier, kBfThreads);\n'
         '      long long h2_ = clock64();\n      RECOMPUTE;\n      long long h3_ = clock64();\n'
         '      repro::named_barrier(kSlotBarrier, kBfThreads);\n'
         '      hw_ += (h1_ - h0_) + (h3_ - h2_); hb_ += (h2_ - h1_) + (clock64() - h3_);\n    }\n'
         '    if (lane == 0) { g_prof[g * 32 + 24] = hw_; g_prof[g * 32 + 25] = hb_; }\n    return;'),
        ('  int qcnt = 0;  // lane j: jobs queued in bucket j\n',
         '  int qcnt = 0;  // lane j: jobs queued in bucket j\n' + START),
        ('    // 1. arrivals: the r-th arrival', '    PROF(0)\n    // 1. arrivals: the r-th arrival'),
        ('    dirty |= arrived;\n    __syncwarp();\n', '    dirty |= arrived;\n    __syncwarp();\n    PROF(1)\n'),
        ('    int n_pend = __reduce_add_sync(repro::kFullMask, my_pend);\n',
         '    int n_pend = __reduce_add_sync(repro::kFullMask, my_pend);\n    CNT(22, n_pend)\n'),
        ('    for (unsigned m = dirty; m; m &= m - 1) rescan(__ffs(m) - 1);\n    dirty = 0u;\n',
         '    PROF(2)\n    for (unsigned m = dirty; m; m &= m - 1) rescan(__ffs(m) - 1);\n'
         '    dirty = 0u;\n    PROF(3)\n'),
        ('      const int occ_max = kCap - glob_min;\n',
         '      const int occ_max = kCap - glob_min;\n      CNT(20, 1)\n'),
        ('        placer = __reduce_min_sync(repro::kFullMask, first);\n',
         '        placer = __reduce_min_sync(repro::kFullMask, first);\n        PROF(4) CNT(21, 1)\n'),
        ('        const int r_k1 = rc & 1, r_js = ((rc >> 1) & 63) - 1, r_ks = rc >> 7;\n',
         '        const int r_k1 = rc & 1, r_js = ((rc >> 1) & 63) - 1, r_ks = rc >> 7;\n        PROF(5)\n'),
        ('        n_pend -= __reduce_add_sync(repro::kFullMask, adv);\n        __syncwarp();\n',
         '        n_pend -= __reduce_add_sync(repro::kFullMask, adv);\n        __syncwarp();\n        PROF(6)\n'),
        ('      const unsigned pk = __reduce_max_sync(repro::kFullMask, bk);\n',
         '      const unsigned pk = __reduce_max_sync(repro::kFullMask, bk);\n      PROF(7)\n'),
        ("        if (pe == rmin[pj]) rescan(pj);  // else the bucket's smallest stays\n      }\n    }\n",
         "        if (pe == rmin[pj]) rescan(pj);  // else the bucket's smallest stays\n      }\n"
         "      PROF(8)\n    }\n"),
        ('    // 4. arrival-side BF-J pass', '    PROF(8)\n    // 4. arrival-side BF-J pass'),
        ('    repro::named_barrier(kSlotBarrier, kBfThreads);\n  }\n  if (lane == 0) {\n'
         '    dropped_out[g] = dropped;',
         '    PROF(9)\n    repro::named_barrier(kSlotBarrier, kBfThreads);\n    PROF(10)\n  }\n'
         '  if (lane == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
    ("bfjs_mr", "block"): [
        ('  int q_cnt = 0, seq0 = 0, dropped = 0, n_trunc = 0;\n',
         '  int q_cnt = 0, seq0 = 0, dropped = 0, n_trunc = 0;\n' + START),
        ('    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n',
         '    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n    PROF(0)\n'),
        ('      seq0 += n_t;\n    }\n', '      seq0 += n_t;\n    }\n    PROF(1)\n'),
        ('    // 3. BF-S: walk the freed servers', '    PROF(2)\n    // 3. BF-S: walk the freed servers'),
        ('      repro::block_arg64<false>(best, bq, redv, redi);\n',
         '      repro::block_arg64<false>(best, bq, redv, redi);\n      PROF(3) CNT(21, 1)\n'),
        ('      ++steps;\n      if (place(l, bq, t) < K) {',
         '      ++steps;\n      CNT(20, 1) CNT(23, 1)\n      if (place(l, bq, t) < K) {'),
        ('        blocked = true;\n      }\n    }\n', '        blocked = true;\n      }\n      PROF(4)\n    }\n'),
        ('    // 4. BF-J: one attempt', '    PROF(4)\n    // 4. BF-J: one attempt'),
        ('      ++steps;\n      const int q = new_pos[a_ptr];',
         '      ++steps;\n      CNT(20, 1) CNT(22, 1)\n      const int q = new_pos[a_ptr];'),
        ('      repro::block_arg64<true>(best, bl, redv, redi);\n',
         '      repro::block_arg64<true>(best, bl, redv, redi);\n      PROF(5)\n'),
        ('        ++n_trunc;\n      }\n    }\n\n    // saturation check',
         '        ++n_trunc;\n      }\n      PROF(6)\n    }\n\n    PROF(6)\n    // saturation check'),
        ('      n_trunc += repro::block_reduce(pend, redi, repro::MaxI());\n    }\n',
         '      n_trunc += repro::block_reduce(pend, redi, repro::MaxI());\n    }\n    PROF(7)\n'),
        ('      ndep_out[t] = n_dep;\n    }\n  }\n',
         '      ndep_out[t] = n_dep;\n    }\n    PROF(8)\n  }\n'),
        ('  if (tid == 0) {\n    dropped_out[g] = dropped;',
         '  if (tid == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
    ("vqs", "block"): [
        ('  int dropped = 0, n_trunc = 0;\n', '  int dropped = 0, n_trunc = 0;\n' + START),
        ('    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n',
         '    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());\n    PROF(0)\n'),
        ('    // 3. visit set\n', '    PROF(1)\n    // 3. visit set\n'),
        ('    bool done = false;\n    for (int step = 0; step <= W; ++step) {\n',
         '    PROF(2)\n    bool done = false;\n    for (int step = 0; step <= W; ++step) {\n'),
        ('      __syncthreads();\n      const unsigned hx = static_cast<unsigned>(bc[kHx]);',
         '      __syncthreads();\n      PROF(3)\n      const unsigned hx = static_cast<unsigned>(bc[kHx]);'),
        ('      key = repro::block_reduce(key, redi, repro::MinI());\n',
         '      key = repro::block_reduce(key, redi, repro::MinI());\n      PROF(4)\n'),
        ('      const int placer = key;\n', '      const int placer = key;\n      CNT(20, 1) CNT(21, placer < L)\n'),
        ('      __syncthreads();\n\n      // serve the placer (warp 0)',
         '      __syncthreads();\n      PROF(5)\n\n      // serve the placer (warp 0)'),
        ('      __syncthreads();\n    }\n    // step bound hit',
         '      __syncthreads();\n      PROF(6)\n    }\n    // step bound hit'),
        ('    if (!done) n_trunc += any_pending(flags, L, redi);\n',
         '    if (!done) n_trunc += any_pending(flags, L, redi);\n    PROF(7)\n'),
        ('    write_slot(occ, qcnt, L, nvq, n_dep, redi, qlen + t, occ_out + t, ndep_out + t);\n',
         '    write_slot(occ, qcnt, L, nvq, n_dep, redi, qlen + t, occ_out + t, ndep_out + t);\n'
         '    __syncthreads();\n    PROF(8)\n'),
        ('  if (tid == 0) {\n    dropped_out[g] = dropped;',
         '  if (tid == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
    ("bfjs_mr", "warp"): [
        STREAM_BFJS_MR,
        ('  int q_cnt = 0, seq0 = 0, dropped = 0, n_trunc = 0;\n',
         '  int q_cnt = 0, seq0 = 0, dropped = 0, n_trunc = 0;\n' + START),
        ('    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kPairThreads) : "memory");\n',
         '    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kPairThreads) : "memory");\n'
         '    PROF(0)\n'),
        ('    seq0 += n_t;\n', '    seq0 += n_t;\n    PROF(1)\n'),
        ('      // the walk: rounds of 32 servers', '      PROF(2)\n      // the walk: rounds of 32 servers'),
        ('              const int q = ok ? bfs_pick(av) : -1;\n',
         '              const int q = ok ? bfs_pick(av) : -1;\n              PROF(3) CNT(21, 1)\n'),
        ('                if (lane == ln) lw &= ~(1u << b);\n                break;',
         '                if (lane == ln) lw &= ~(1u << b);\n                PROF(4)\n                break;'),
        ('              ++steps;\n              int d[R];', '              ++steps;\n              CNT(23, 1)\n              int d[R];'),
        ('                blocked = true;\n              }\n            }\n',
         '                blocked = true;\n              }\n              PROF(4)\n            }\n'),
        ('    // 4. BF-J: one attempt', '    PROF(4)\n    // 4. BF-J: one attempt'),
        ('        const unsigned long long k = bfj_scan(d);\n',
         '        const unsigned long long k = bfj_scan(d);\n        PROF(5) CNT(19, 1)\n'),
        ('        if (!place(static_cast<int>(k & 0xffffffu), q, d)) ++n_trunc;\n      }\n',
         '        if (!place(static_cast<int>(k & 0xffffffu), q, d)) ++n_trunc;\n        PROF(6)\n      }\n'),
        ('    // saturation check, when the steps ran out',
         '    PROF(6) CNT(20, steps) CNT(22, a_ptr)\n    // saturation check, when the steps ran out'),
        ('      n_trunc += pend ? 1 : 0;\n    }\n', '      n_trunc += pend ? 1 : 0;\n    }\n    PROF(7)\n'),
        ('    repro::named_barrier(kSlotBarrier, kPairThreads);\n  }\n  if (lane == 0) {\n    dropped_out[g] = dropped;',
         '    PROF(8)\n    repro::named_barrier(kSlotBarrier, kPairThreads);\n    PROF(9)\n  }\n'
         '  if (lane == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
    ("vqs", "warp"): [
        STREAM_VQS,
        ('  const unsigned lanes_below = (1u << lane) - 1u;\n',
         '  const unsigned lanes_below = (1u << lane) - 1u;\n' + START),
        ('    __syncwarp();\n    refresh_head();\n', '    __syncwarp();\n    refresh_head();\n    PROF(0)\n'),
        ('    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kVqsThreads) : "memory");\n',
         '    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kVqsThreads) : "memory");\n'
         '    PROF(1) CNT(22, n_pend)\n'),
        ('      const int he1 = heff[1];\n', '      const int he1 = heff[1];\n      PROF(2) CNT(20, 1)\n'),
        ('      n_pend -= __reduce_add_sync(repro::kFullMask, adv);\n      __syncwarp();\n',
         '      n_pend -= __reduce_add_sync(repro::kFullMask, adv);\n      __syncwarp();\n      PROF(3)\n'),
        ('      // the p-th job goes to the p-th empty slot', '      PROF(4) CNT(21, 1)\n      // the p-th job goes to the p-th empty slot'),
        ('      n_trunc += max(m - free_cnt, 0);  // K-overflow\n      __syncwarp();\n    }\n',
         '      n_trunc += max(m - free_cnt, 0);  // K-overflow\n      __syncwarp();\n      PROF(5)\n    }\n'),
        ('    repro::named_barrier(kSlotBarrier, kVqsThreads);\n  }\n  if (lane == 0) {\n    dropped_out[g] = dropped;',
         '    PROF(6)\n    repro::named_barrier(kSlotBarrier, kVqsThreads);\n    PROF(7)\n  }\n'
         '  if (lane == 0) {\n' + STORE + '    dropped_out[g] = dropped;'),
    ],
}


def design(kernel: str, text: str) -> str:
    """'block' for the 512-thread block-wide kernels, 'warp' for the
    decision-warp kernels."""
    if kernel in ("bfjs", "bfjs_mr"):
        return "block" if "constexpr int kThreads = 512;" in text else "warp"
    if kernel == "best_fit":
        return "block" if "block_arg" in text else "warp"
    return "block" if "block_reduce" in text else "warp"


def instrument(kernel: str, text: str) -> str:
    include = '#include "reduce.cuh"\n'
    text = text.replace(include, include + HEAD, 1)
    for anchor, repl in PATCHES[(kernel, design(kernel, text))]:
        # an anchor may list the forms of several revisions: the one present is patched
        for a in anchor if isinstance(anchor, tuple) else (anchor,):
            if text.count(a) == 1:
                if isinstance(anchor, tuple):  # keep that revision's own calls
                    old = "classify_slot(t + 1)" in a
                    repl = repl.replace("LOAD_SLOT", "classify_slot" if old else "load_slot")
                    repl = repl.replace("RECOMPUTE", "recompute(t)" if old else
                                        "recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t)")
                text = text.replace(a, repl)
                break
        else:
            raise SystemExit(f"{kernel}: anchor not found exactly once:\n{anchor}")
    return text + TAIL


def build(srcs, kernels, prof: bool):
    """Compile every (source, kernel), one nvcc each, all at once."""
    from repro_torch.kernels import build as kbuild
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for d, tag in srcs:
        for name in kernels:
            variants = [("", Path(d))]
            if prof:
                pdir = OUT / f"{tag}-prof"
                pdir.mkdir(exist_ok=True)
                for h in Path(d).glob("*.cuh"):
                    shutil.copy(h, pdir / h.name)
                (pdir / f"{name}.cu").write_text(instrument(name, (Path(d) / f"{name}.cu").read_text()))
                variants.append(("-prof", pdir))
            for suffix, sd in variants:
                src = sd / f"{name}.cu"
                digest = hashlib.sha256(b"".join(p.read_bytes() for p in sorted(sd.glob("*.cu*")))
                                        ).hexdigest()[:12]
                so = OUT / f"{tag}{suffix}-{name}-{digest}.so"
                cmd = [kbuild.nvcc_path(), *kbuild.NVCC_FLAGS, "-I", str(sd), "-o", str(so), str(src)]
                procs[(tag + suffix, name)] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so, src)
    libs = {}
    for key, (proc, so, src) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{log}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def launch_best_fit(lib, inputs):
    """One ``best_fit_launch`` on ``inputs`` (residuals, sizes)."""
    import torch
    resid, sizes = inputs
    G, L = resid.shape
    N = sizes.shape[1]
    out = [torch.empty((G, N), dtype=torch.int32, device=resid.device), torch.empty_like(resid)]
    fn = lib.best_fit_launch
    fn.argtypes = [P, P, I, I, I, P, P, P]
    fn.restype = I
    err = fn(resid.data_ptr(), sizes.data_ptr(), G, L, N, out[0].data_ptr(), out[1].data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise SystemExit(f"best_fit launch failed: CUDA error {err}")
    return out


def launch(lib, name, st, cfg):
    import torch
    from repro_torch.core.engine.ops import k_red_t
    if name == "best_fit":
        return launch_best_fit(lib, st)
    n, sizes, durs = st.n, st.sizes, st.durs
    G, T = n.shape
    dev = n.device
    R = cfg.get("R", 1)
    out = [torch.empty((G, T), dtype=torch.int32, device=dev),
           torch.empty((G, T) if name != "bfjs_mr" else (G, T, R), dtype=torch.float32,
                       device=dev),
           torch.empty((G, T), dtype=torch.int32, device=dev),
           torch.zeros(G, dtype=torch.int32, device=dev),
           torch.zeros(G, dtype=torch.int32, device=dev)]
    ptrs = [x.data_ptr() for x in out]
    stream = torch.cuda.current_stream().cuda_stream
    if name == "bfjs":
        fn = lib.bfjs_launch
        fn.restype = I
        fn.argtypes = [P, P, P] + [I] * 7 + [P] * 6
        err = fn(n.data_ptr(), sizes.data_ptr(), durs.data_ptr(), G, T, cfg["L"], cfg["K"],
                 cfg["Qcap"], cfg["A"], cfg["W"], *ptrs, stream)
    elif name == "bfjs_mr":
        wsb = lib.bfjs_mr_workspace_bytes
        wsb.restype = S
        wsb.argtypes = [I] * 5
        ws = torch.empty(G * wsb(cfg["L"], cfg["K"], cfg["Qcap"], cfg["A"], R), dtype=torch.uint8,
                         device=dev)
        caps = (ctypes.c_int * R)(*([65536] * R))
        fn = lib.bfjs_mr_launch
        fn.restype = I
        fn.argtypes = [P, P, P] + [I] * 9 + [P] * 8
        err = fn(n.data_ptr(), sizes.data_ptr(), durs.data_ptr(), G, T, cfg["L"], cfg["K"], R,
                 cfg["Qcap"], cfg["A"], durs.shape[2], cfg["W"], ctypes.cast(caps, P),
                 ws.data_ptr(), *ptrs, stream)
    else:  # vqs_bf, vqs: the same entry-point signature
        J = cfg["J"]
        wsb = getattr(lib, f"{name}_workspace_bytes")
        wsb.restype = S
        wsb.argtypes = [I] * 5
        ws = torch.empty(G * wsb(J, cfg["L"], cfg["K"], cfg["Qcap"], cfg["A"]), dtype=torch.uint8,
                         device=dev)
        confs = k_red_t(J, dev)
        fn = getattr(lib, f"{name}_launch")
        fn.restype = I
        fn.argtypes = [P] * 4 + [I] * 10 + [P] * 7
        err = fn(n.data_ptr(), sizes.data_ptr(), durs.data_ptr(), confs.data_ptr(), G, T, J,
                 cfg["L"], cfg["K"], cfg["Qcap"], cfg["A"], durs.shape[2], cfg["W"],
                 cfg.get("P", 0), ws.data_ptr(), *ptrs, stream)
    if err:
        raise SystemExit(f"{name} launch failed: CUDA error {err}")
    return out


def timed(lib, name, st, cfg, reps: int = 3):
    import torch
    launch(lib, name, st, cfg)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = launch(lib, name, st, cfg)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps, out


def split(lib, name, text, st, cfg, G, T, unit="slot"):
    import torch
    lib.prof_clear.restype = I
    if lib.prof_clear():
        raise SystemExit("clearing the counters failed")
    launch(lib, name, st, cfg)
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (4096 * NCOUNT))()
    lib.prof_read.argtypes = [P, I]
    lib.prof_read.restype = I
    if lib.prof_read(buf, G * NCOUNT):
        raise SystemExit("reading the counters failed")
    mean = torch.tensor(list(buf)[: G * NCOUNT], dtype=torch.float64).view(G, NCOUNT).mean(0)
    total = float(mean[31])
    print(f"  total {total / T:.0f} cycles a {unit}")
    for i, label in NAMES[(name, design(name, text))].items():
        v = float(mean[i]) / T
        if label.startswith("#"):
            print(f"  {label[1:]:18s} {v:10.3f} a {unit}")
        else:
            print(f"  {label:18s} {v:10.0f} cycles a {unit} {100 * float(mean[i]) / total:6.1f}%")


def best_fit_cell(c, cfg, srcs, order, libs, prof: bool) -> None:
    """Time every source in turns on one best_fit cell, check them equal,
    then split each."""
    import numpy as np
    import torch
    G, L, N = cfg["G"], cfg["L"], cfg["N"]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    inputs = (torch.from_numpy(rng.uniform(0, 1, (G, L)).astype(np.float32)).to(dev),
              torch.from_numpy(rng.uniform(0.01, 0.3, (G, N)).astype(np.float32)).to(dev))
    texts = {tag: (Path(d) / "best_fit.cu").read_text() for d, tag in srcs}
    outs = {}
    for tag in order:
        ms, outs[tag] = timed(libs[(tag, "best_fit")], "best_fit", inputs, cfg, reps=10)
        print(f"{c} {tag}: {ms:.4f} ms; placed {int((outs[tag][0] >= 0).sum())} of {G * N}",
              flush=True)
    first = next(iter(outs))
    for label, out in outs.items():
        if label != first:
            same = all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(outs[first], out))
            print(f"{c} {label} equal to {first}: {same}")
            if not same:
                raise SystemExit(1)
    if prof:
        for tag in texts:
            print(f"--- {c} {tag} ({design('best_fit', texts[tag])} design), split by phase:")
            split(libs[(tag + "-prof", "best_fit")], "best_fit", texts[tag], inputs, cfg, G, N,
                  unit="job")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append", required=True,
                    help="DIR[:TAG], a directory with the kernels' sources")
    ap.add_argument("--which", default=",".join(CELLS))
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--prof", action="store_true")
    ap.add_argument("--G", type=int, default=128)
    ap.add_argument("--T", type=int, default=1000)
    a = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("sched_kernel_split: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.core.engine import ensemble_streams

    srcs = [(s.split(":")[0], s.split(":")[1] if ":" in s else Path(s).name) for s in a.src]
    cells = a.which.split(",")
    libs = build(srcs, sorted({CELLS[c][0] for c in cells}), a.prof)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    def sampler(R):
        def draw(gen, n, device):
            return torch.rand((n,) if R == 1 else (n, R), generator=gen, device=device) * 0.8 + 0.1
        return draw

    tags = [t for _, t in srcs]
    order = []
    for i in range(a.turns):
        order += tags if i % 2 == 0 else tags[::-1]
    for c in cells:
        name, cfg, lam = CELLS[c]
        if name == "best_fit":
            best_fit_cell(c, cfg, srcs, order, libs, a.prof)
            continue
        R = cfg.get("R", 1)
        st = ensemble_streams(range(a.G), lam, 0.01, sampler(R), L=cfg["L"], K=cfg["K"],
                              A_max=cfg["A"], horizon=a.T, device=torch.device("cuda"),
                              num_resources=R)
        outs = {}
        for tag in order:
            ms, out = timed(libs[(tag, name)], name, st, cfg)
            outs[tag] = out
            print(f"{c} {tag}: {ms:.4f} ms; mean queue {float(out[0].double().mean()):.3f}, "
                  f"dropped {int(out[3].sum())}, truncated {int(out[4].sum())}", flush=True)
        for tag in tags[1:]:
            same = all(torch.equal(x, y) for x, y in zip(outs[tags[0]], outs[tag]))
            print(f"{c} {tag} equal to {tags[0]}: {same}")
            if not same:
                return 1
        if a.prof:
            for d, tag in srcs:
                text = (Path(d) / f"{name}.cu").read_text()
                print(f"--- {c} {tag} ({design(name, text)} design), split by phase:")
                split(libs[(tag + "-prof", name)], name, text, st, cfg, a.G, a.T)
        del st, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
