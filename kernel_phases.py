#!/usr/bin/env python3
"""Split kernels A (mel frontend), B (small-N Viterbi), D (the factored
forward's rank-1 and backoff kinds), G
(forward-backward, chunked route), H (the trigram decode's forward), I
(the WebRTC VAD's GMM), J (the adaptive LTSD's noise recursion) and K
(the masked Viterbi trellis, warp route) of a checkout into phases on one
NVIDIA GPU, with ``clock64()`` stamps.

    python3 kernel_phases.py --root DIR [--out FILE] [--sass DIR] [--kernels A,B,D,G,H,I,J,K]

The kernel sources under ``DIR/lnasr_tpu_torch/csrc`` are copied, a
``clock64()`` stamp is inserted at each phase boundary (text patches keyed
by the lines they follow; a source whose anchors are missing is refused),
and the copy is built with ``nvcc`` under ``_archive/phases/`` (with
``csrc/`` on the include path, for its local headers). The
committed sources never carry the stamps. Each block (A) or warp (B)
records its stamps from its first thread; the script prints the mean
cycles of each phase over the blocks or warps, the shares, and the event
time of the stamped and of the unstamped kernel (the stamps' cost):

- A at the flagship shape (B = 64 x 10 s) and the segment shape (B = 1,
  T = 511): the block-wide radix-2 FFT (the first port) in signal load,
  window/pack, butterflies, split/power, mel + energy (per block); the
  warp-per-frame FFT in span + constants load, window/pack, FFT passes,
  split/power + energy, mel + stores (each warp's first frame);
- B at the flagship shape (B = 64, T = 999, N = 5): forward and backtrace,
  the backtrace of the chunk-map version split into its three phases;
- G's chunked route at the EM sweep's shape (B = 64, T = 999, float32,
  N = 5 and 8): the chunk's staging and product (phase 1), the boundary
  chain (phase 2), the replay and stores (phase 3), each up to the
  block's barrier after it (per block), and the cycles a step of each;
- H's forward at the V = 200 trigram segment (T = 511, H = 202), at
  float32 and float64 on every route of ``ops.trigram.ROUTES`` that takes
  each: the load before the frame loop (on the resident route the
  block's ``hop3`` columns into registers and shared memory), the frame
  loop's within-word pass, the wait for the other blocks' exits, the hop
  pass and the publication of its own, each summed over the frames from
  the block's first thread, then the final argmax (per block), and the
  cycles a valid step of each frame-loop phase;
- D's rank-1 and backoff kinds at the V = 5000 serving segment (both
  kinds) and at ``bench/decoder``'s 5k and 10k graphs (backoff): a valid
  frame's within-word step, the wait for the exchange (the blocks'
  partials and the block's own arcs' sources), the partials' combine, the
  arc pass, the entry and the rows, and the closing barrier with the
  partials' publication, each summed over the frames from the block's
  first thread, and the cycles a valid step of each; the stamped grids
  must be the unstamped kernel's and the plain forward's, bit for bit;
- I on the stream's features (6,292 frames, mode 0): the GMM warp's
  decision (likelihoods, ratio, flag), adaptation (both outcomes) and
  select (the flag's outcome, the next frame's state-only terms) a frame
  with power, its waits for the tracker warps' stages, and the first
  tracker warp's frame loops (aging, insertion, smoothed minimum), each
  summed over the frames by its warp's first lane, and the cycles a frame
  of each, and the frames redone with ``__fdiv_rn``; the shares are of
  the GMM warp's own time (a checkout from
  before the tracker warps: one warp's decision, minimum tracker and
  adaptation a frame). The stamped kernel's flags and final state must be
  the unstamped one's, bit for bit;
- J on the stream at float32 (``LTSDConfig(alpha=0.4)``, 972 valid frames
  of 1025 bins), a frame's phases summed over the band: with division
  warps and a combiner warp, the first division lane's wait for the last
  flag and its select, the wait for the row's stage, both candidates'
  divisions, the butterflies and the publication of the partials, and
  beside them the combiner's wait for the partials, their sum, the tail
  (division by win, log10, compare), the flag's publication and the
  score's store and the stage's refill (each role's own totals: they run
  side by side); a checkout from before it (one barrier a frame, the
  block's first thread): the divisions, the butterflies, the barrier, the
  partials' sum, the tail, the adaptation and the wait for the next row's
  load;
- K's warp route at ``GMMHMM.decode_batch``'s inputs (B = 64, T = 999,
  N = 5, seeded ragged masks): a step's shuffles and tree, mask select and
  row stores, each group's copy of its rows and prefetch, summed over the
  forward from the warp's first lane, the forward's unstamped rest, then
  the backtrace's three phases as B's. J's and K's stamped outputs must be
  the unstamped ones and their plain loops', bit for bit.

Each launch goes through the checkout's own wrapper (``ops.*._launch``)
pointed at the stamped library, and its output is checked against the
plain version as ``chip_smoke.py`` checks it.

``--sass DIR`` also writes ``cuobjdump -sass`` of each unstamped library
there, for counting the instructions on a kernel's dependent chain.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "_archive", "phases")
N_STAMPS = 1 << 20

HEADER = """
__device__ unsigned long long g_stamps[%d];
#define STAMP(slot) (g_stamps[(slot)] = clock64())
""" % N_STAMPS

FOOTER = """
extern "C" int read_stamps(unsigned long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * n);
}
extern "C" int clear_stamps() {
    void* p = nullptr;
    cudaError_t err = cudaGetSymbolAddress(&p, g_stamps);
    return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_stamps)));
}
"""

def _acc(q, indent):
    """Source text that adds the cycles since the last mark to phase ``q``
    (kernels whose phases sit inside a frame loop)."""
    return (" " * indent + "{ unsigned long long n_ = clock64(); "
            + f"ph_acc[{q}] += n_ - ph_t; ph_t = n_; }}\n")


def _acc32(q, indent):
    """:func:`_acc` in 32 bits (kernel H: a phase's cycles over a launch)."""
    return (" " * indent + "{ const unsigned n_ = (unsigned)clock64(); "
            + f"ph_acc[{q}] += n_ - ph_t; ph_t = n_; }}\n")


def _sh(q):
    """Kernel I's GMM frame (its branch-free pass): the cycles since the
    last mark into ``ph_sh[q]`` from lane 0."""
    return ("    if (FAST && threadIdx.x == 0) { const unsigned long long n_ = clock64(); "
            f"ph_sh[{q}] += n_ - ph_sh[6]; ph_sh[6] = n_; }}\n")


def _h_final(stride):
    """Kernel H's stamps at its end, from the block's first thread: 1, then
    the running totals of the load, the four frame-loop phases and the
    final argmax."""
    return ("    if (threadIdx.x == 0) {\n        unsigned long long c_ = 1;\n"
            f"        g_stamps[blockIdx.x * {stride}] = c_;\n"
            f"        g_stamps[blockIdx.x * {stride} + 1] = c_ += ph_load;\n"
            "        for (int q = 0; q < 4; ++q)\n"
            f"            g_stamps[blockIdx.x * {stride} + 2 + q] = c_ += ph_acc[q];\n"
            f"        g_stamps[blockIdx.x * {stride} + 6] = c_ + ((unsigned)clock64() - fin_t);\n"
            "    }\n")


def _final(stride, n, cond, indent):
    """Phases summed inside a loop, written once by the first thread when
    ``cond`` holds: 1, then the running totals of ``ph_acc[0..n)``."""
    pad = " " * indent
    return (f"{pad}if ({cond} && threadIdx.x == 0) {{\n"
            f"{pad}    unsigned long long c_ = 1;\n"
            f"{pad}    g_stamps[blockIdx.x * {stride}] = c_;\n"
            f"{pad}    for (int q = 0; q < {n}; ++q)\n"
            f"{pad}        g_stamps[blockIdx.x * {stride} + 1 + q] = c_ += ph_acc[q];\n"
            f"{pad}}}\n")


# kernel J: a frame's phases summed over the band by every thread, written
# by the block's first thread at the last frame (per block: an utterance)
J_PHASES_V1 = ["divisions", "butterflies", "barrier wait", "partials' sum", "tail", "adaptation",
               "next row's load"]
# the division warps' five phases, then the combiner's five: each role's
# own totals (the two run side by side), between markers (slots 0 and 11)
J_PHASES = ["row loads + flag wait + select", "row wait", "divisions", "butterflies", "publish",
            "partials wait", "partials' sum", "tail", "flag publish", "score + refill"]
J_STRIDE = 12
RAW = {"division warps and a combiner warp"}  # versions whose slots are raw totals
# kernel K's warp route: a step's phases summed over the forward from the
# warp's first lane and written at its end as running totals from the
# clock at its start, the forward's unstamped rest up to the final argmax,
# then the backtrace's three phases as kernel B's (clock stamps)
K_PHASES = ["shuffles + tree", "mask select", "row stores", "group copy", "group prefetch",
            "forward other", "final argmax + chunk walks", "map composition", "path fill"]
K_STRIDE = 10
K_START = ("    unsigned ph_acc[5] = {0, 0, 0, 0, 0};\n"
           "    const unsigned long long ph_base = clock64();\n"
           "    unsigned ph_t = (unsigned)ph_base;\n")
K_FORWARD_END = ("    if (lane == 0) {\n"
                 "        unsigned long long c_ = ph_base;\n"
                 f"        g_stamps[blockIdx.x * {K_STRIDE}] = c_;\n"
                 "        for (int q = 0; q < 5; ++q)\n"
                 f"            g_stamps[blockIdx.x * {K_STRIDE} + 1 + q] = c_ += ph_acc[q];\n"
                 f"        g_stamps[blockIdx.x * {K_STRIDE} + 6] = clock64();\n"
                 "    }\n")
K_BACKTRACE = [  # the backtrace shared by both routes
    ("            if (w < n_walks) maps[w] = (int16_t)s[q];\n        }\n    }\n    barrier<BLOCK>();\n",
     f"    if (tid == 0) STAMP(blockIdx.x * {K_STRIDE} + 7);\n"),
    ("            ends[c - 1] = (int16_t)e;\n        }\n    }\n    barrier<BLOCK>();\n",
     f"    if (tid == 0) STAMP(blockIdx.x * {K_STRIDE} + 8);\n"),
    ("                    pb[t - 1] = s[q];\n                }\n            }\n        }\n    }\n",
     f"    barrier<BLOCK>();\n    if (tid == 0) STAMP(blockIdx.x * {K_STRIDE} + 9);\n"),
]

# kernel D's factored kinds (rank-1 and backoff): a valid frame's phases
# summed over the frames by every thread in 32 bits, written by the block's
# first thread (a word's state 0; it also publishes the partials)
D_PHASES = ["within-word step", "exchange wait", "partials' combine", "arc pass + barrier",
            "entry + rows", "barrier + publish"]
D_STRIDE = 8
D_PATCHES = [
    ("    bool valid_next = T > 1 && (p.mask == nullptr || p.mask[1]);\n",
     "    unsigned ph_acc[6] = {0, 0, 0, 0, 0, 0}, ph_t = (unsigned)clock64();\n"),
    ("        float e = 0.0f, m = -INFINITY;\n", _acc32(5, 8)),
    ("            // the sparse keys' reset: every read of the last frame's is done\n",
     _acc32(0, 12)),
    ("                       bsrc, n_src, (unsigned)last_pub, got);\n"
     "            __syncthreads();  // also: every read of g is done\n", _acc32(1, 12)),
    ("            combine_polled(got, p.n_blocks, rk);\n", _acc32(2, 12)),
    ("            __syncthreads();  // the warps' combines (and the arcs' atomics) are done\n",
     _acc32(3, 12)),
    ("        ++n_pub;\n        last_pub = t;\n", _acc32(4, 8)),
    ("        if (kFactors) publish_partials(wk, part, p.n_blocks, n_pub & 1, t);\n    }\n",
     "    { const unsigned n_ = (unsigned)clock64(); ph_acc[5] += n_ - ph_t; }\n"
     + _final(D_STRIDE, 6, "kFactors", 4)),
]
# the same phases of the batched kernel (a launch steps every utterance's
# items in each phase; the within-word step also issues the emissions' copies)
D_BATCH_PATCHES = [
    ("    unsigned long long live_next = T > 1 ? frame_bits(p.mask, B, T, 1) : 0;\n",
     "    unsigned ph_acc[6] = {0, 0, 0, 0, 0, 0}, ph_t = (unsigned)clock64();\n"),
    ("        // this frame's emissions (in flight) and the block's own\n", _acc32(5, 8)),
    ("            // the sparse keys' reset: every read of the last frame's is done\n",
     _acc32(0, 12)),
    ("                       p.xch + (size_t)(n_pub & 1) * B * V, bsrc, n_src, B, V, "
     "(unsigned)last_pub, pl.got);\n"
     "            __syncthreads();  // also: every read of g is done\n", _acc32(1, 12)),
    ("            combine_polled(pl.got, p.n_blocks, B, pl.rk);\n", _acc32(2, 12)),
    ("            __syncthreads();  // the warps' combines (and the arcs' atomics) are done\n",
     _acc32(3, 12)),
    ("        ++n_pub;\n        last_pub = t;\n", _acc32(4, 8)),
    ("        if (kFactors) publish_partials(pl.xk, p.wpb, nw, part, B, p.n_blocks, n_pub & 1, t);\n"
     "    }\n",
     "    { const unsigned n_ = (unsigned)clock64(); ph_acc[5] += n_ - ph_t; }\n"
     + _final(D_STRIDE, 6, "kFactors", 4)),
]
I_PHASES = ["decision", "adaptation", "select", "ring wait", "tracker frames"]
H_PHASES = ["load", "within-word pass", "exchange wait", "hop pass", "publish", "final argmax"]
# kernel H's sums are 32-bit (a phase's cycles over a launch fit), which
# keeps the stamps' registers few
H_ROW_PATCHES = [  # the row routes' kernel
    ("    for (int k = tid; k < V; k += nth) eidx[k] = p.exit_idx[k];\n",
     "    unsigned ph_acc[4] = {0, 0, 0, 0}, ph_t = 0;\n"
     "    const unsigned ph_t0 = (unsigned)clock64();\n"),
    ("    publish(gc, p.xch, 0, 0u, h0, nr, H, V, S, eidx);\n",
     "    const unsigned ph_load = (unsigned)clock64() - ph_t0;\n"),
    ("        const T* lb = log_b + (size_t)t * VS;\n", "        ph_t = (unsigned)clock64();\n"),
    ("                __stcs(bt + k, base_id + k - s + src);\n            }\n        }\n",
     _acc32(0, 8)),
    ("                   max(nhop, 1) * H * W, reinterpret_cast<unsigned*>(ex));\n"
     "        __syncthreads();\n", _acc32(1, 8)),
    ("            gn[cell] = m + lb[w * S];\n            __stcs(bt + cell, b);\n"
     "        }\n        __syncthreads();\n", _acc32(2, 8)),
    ("        gc = gn;\n        gn = tmp;\n", _acc32(3, 8)),
    ("    T bv = ninf;\n    int bi = INT_MAX;\n",
     "    const unsigned fin_t = (unsigned)clock64();\n"),
    ("        *static_cast<T*>(p.score) = v;\n        *p.last = i;\n    }\n", _h_final(7)),
]
H_RESIDENT_PATCHES = [  # no barrier follows its hop pass: thread 0's own hop copy
    ("    for (int k = tid; k < V; k += R_THREADS) eidx[k] = p.exit_idx[k];\n",
     "    unsigned ph_acc[4] = {0, 0, 0, 0}, ph_t = 0;\n"
     "    const unsigned ph_t0 = (unsigned)clock64();\n"),
    ("        st_relaxed(p.xch + xo, (unsigned long long)__float_as_uint(g[e_st]));\n"
     "    }\n", "    const unsigned ph_load = (unsigned)clock64() - ph_t0;\n"),
    ("        const float* lw = log_b + (size_t)t * VS + w * S;  // this copy's emissions\n",
     "        ph_t = (unsigned)clock64();\n"),
    ("            store_pointers(bt, bp, S);\n        }\n", _acc32(0, 8)),
    ("        read_columns(src, last_pub, 2 * R_THREADS, n_words, H, ht, ex_b);\n"
     "        __syncthreads();\n", _acc32(1, 8)),
    ("        if (own && (!hopper || e_st != 0)) st_relaxed(out + xo, tag | "
     "__float_as_uint(g[e_st]));\n", _acc32(3, 8)),  # exits published before the hop
    ("            g[0] = m + emit0;\n", _acc32(2, 12)),
    ("            if (e_st == 0) st_relaxed(out + xo, tag | __float_as_uint(g[0]));\n",
     _acc32(3, 12)),  # and after it
    ("    // elsewhere; the first flattened state of the maximum\n",
     "    const unsigned fin_t = (unsigned)clock64();\n"),
    ("        *static_cast<float*>(p.score) = v;\n        *p.last = i;\n    }\n", _h_final(7)),
]

# the same phases in the kernels that step a batch's utterances in turn
# (one utterance: its own instantiation, the phases as above)
H_BATCH_ROW_PATCHES = [
    ("    for (int k = tid; k < V; k += nth) eidx[k] = p.exit_idx[k];\n",
     "    unsigned ph_acc[4] = {0, 0, 0, 0}, ph_t = 0;\n"
     "    const unsigned ph_t0 = (unsigned)clock64();\n"),
    ("        publish(rows0 + b * per_utt, p.xch + (size_t)b * 2 * V * H * W, 0, 0u, h0, nr, H, V, "
     "S,\n                eidx);\n", "    const unsigned ph_load = (unsigned)clock64() - ph_t0;\n"),
    ("            const T* lb = log_b + ((size_t)b * p.n_t + t) * VS;\n",
     "            ph_t = (unsigned)clock64();\n"),
    ("                    __stcs(bt + k, base_id + k - s + src);\n                }\n            }\n",
     _acc32(0, 12)),
    ("                       max(nhop, 1) * H * W, reinterpret_cast<unsigned*>(ex));\n"
     "            __syncthreads();\n", _acc32(1, 12)),
    ("                gn[cell] = m + lb[w * S];\n                __stcs(bt + cell, from);\n"
     "            }\n            __syncthreads();\n", _acc32(2, 12)),
    ("            publish(gn, xch, (n_pub + 1) & 1, (unsigned)t, h0, nr, H, V, S, eidx);\n",
     _acc32(3, 12)),
    ("    // state, -inf elsewhere, the first flattened state of the maximum\n",
     "    const unsigned fin_t = (unsigned)clock64();\n"),
    ("            static_cast<T*>(p.score)[b] = v;\n            p.last[b] = i;\n        }\n    }\n",
     _h_final(7)),
]
H_BATCH_RESIDENT_PATCHES = [
    ("    for (int k = tid; k < V; k += R_THREADS) eidx[k] = p.exit_idx[k];\n",
     "    unsigned ph_acc[4] = {0, 0, 0, 0}, ph_t = 0;\n"
     "    const unsigned ph_t0 = (unsigned)clock64();\n"),
    ("                       (unsigned long long)__float_as_uint(g[e_st * gj]));\n        }\n    }\n",
     "    const unsigned ph_load = (unsigned)clock64() - ph_t0;\n"),
    ("            const float* lw = log_b + ((size_t)b * p.n_t + t) * VS + w * S;  // this copy's "
     "emissions\n", "            ph_t = (unsigned)clock64();\n"),
    ("                store_pointers(bt, bp, S);\n            }\n", _acc32(0, 12)),
    ("            read_columns(src, last_pub, 2 * R_THREADS, n_words, H, ht, ex_b);\n"
     "            __syncthreads();\n", _acc32(1, 12)),
    ("                st_relaxed(out + xo, tag | __float_as_uint(g[e_st * gj]));\n",
     _acc32(3, 12)),  # exits published before the hop
    ("                g[0] = m + emit0;\n", _acc32(2, 16)),
    ("                if (e_st == 0) st_relaxed(out + xo, tag | __float_as_uint(g[0]));\n",
     _acc32(3, 16)),  # and after it
    ("    // state, -inf elsewhere; the first flattened state of the maximum\n",
     "    const unsigned fin_t = (unsigned)clock64();\n"),
    ("            static_cast<float*>(p.score)[b] = v;\n            p.last[b] = i;\n        }\n"
     "    }\n", _h_final(7)),
]

# (anchor, text inserted after it) per kernel and version; the first set
# whose anchors all occur once in the source is applied (the warp route's
# first: the file that has it keeps the block-wide route as well)
A_BLOCK = "(blockIdx.y * gridDim.x + blockIdx.x) * 6"
A_WARP = "((blockIdx.y * gridDim.x + blockIdx.x) * 8 + warp) * 6"
PATCH_SETS = {
    "mel_frontend": [
        # the warp route: each warp's first frame
        ("warp-per-frame FFT", 6,
         ["span + constants load", "window/pack", "FFT passes", "split/power + energy",
          "mel + stores"], [
             ("    const int t0 = blockIdx.x * fpb;\n",
              f"    if (lane == 0) STAMP({A_WARP} + 0);\n"),
             ("i < span; i += blockDim.x) seg[i] = 0.0f;\n    __syncthreads();\n",
              f"    if (lane == 0) STAMP({A_WARP} + 1);\n"),
             ("                vi[m] = (double)seg[fo + n + 1] * w2.y;\n            }\n        }\n",
              f"        if (lane == 0 && f == warp) STAMP({A_WARP} + 2);\n"),
             ("        fft_passes<H, 0>(vr, vi, pr, pi, tw_s, lane);\n",
              f"        if (lane == 0 && f == warp) STAMP({A_WARP} + 3);\n"),
             ("part += __shfl_xor_sync(FULL, part, off);\n        __syncwarp();\n",
              f"        if (lane == 0 && f == warp) STAMP({A_WARP} + 4);\n"),
             ("        if (lane == 0) energy[row] = (float)part;\n",
              f"        if (lane == 0 && f == warp) STAMP({A_WARP} + 5);\n"),
         ]),
        ("block-wide radix-2 FFT", 6,
         ["signal load", "window/pack", "butterflies", "split/power", "mel + energy"], [
             ("    const float* yb = y + (size_t)b * S;\n",
              f"    if (tid == 0) STAMP({A_BLOCK} + 0);\n"),
             ("        tws[k] = tw_sin[k];\n    }\n    __syncthreads();\n",
              f"    if (tid == 0) STAMP({A_BLOCK} + 1);\n"),
             ("        zim[f * half + r] = x1;\n    }\n    __syncthreads();\n",
              f"    if (tid == 0) STAMP({A_BLOCK} + 2);\n"),
             ("            zim[i1] = ui - ti;\n        }\n        __syncthreads();\n    }\n",
              f"    if (tid == 0) STAMP({A_BLOCK} + 3);\n"),
             ("        pw[idx] = (xr * xr + xi * xi) * inv_n;\n    }\n    __syncthreads();\n",
              f"    if (tid == 0) STAMP({A_BLOCK} + 4);\n"),
             ("            energy[(size_t)b * T + t] = acc;\n        }\n    }\n",
              f"    __syncthreads();\n    if (tid == 0) STAMP({A_BLOCK} + 5);\n"),
         ]),
    ],
    "viterbi": [
        ("frame-by-frame backtrace", 3, ["forward", "backtrace"], [
            ("    float v = on ? log_pi[lane] + lb[lane] : NEG_INF;\n",
             "    if (lane == 0) STAMP(b * 3 + 0);\n"),
            ("        for (int k = 0; k < STEPS; ++k) cur[k] = nxt[k];\n    }\n",
             "    __syncwarp();\n    if (lane == 0) STAMP(b * 3 + 1);\n"),
            ("                pb[t - 1] = state;\n            }\n        }\n"
             "        __syncwarp();\n    }\n",
             "    if (lane == 0) STAMP(b * 3 + 2);\n"),
        ]),
        ("chunk-map backtrace", 5,
         ["forward", "final argmax + chunk walks", "map composition", "path fill"], [
            ("    float v = on ? log_pi[lane] + lb[lane] : NEG_INF;\n",
             "    if (lane == 0) STAMP(b * 5 + 0);\n"),
            ("        for (int k = 0; k < STEPS; ++k) cur[k] = nxt[k];\n    }\n",
             "    __syncwarp();\n    if (lane == 0) STAMP(b * 5 + 1);\n"),
            ("            if (w < n_walks) maps[w] = (int8_t)s[q];\n        }\n    }\n"
             "    __syncwarp();\n",
             "    if (lane == 0) STAMP(b * 5 + 2);\n"),
            ("            ends[c - 1] = (int8_t)e;\n        }\n    }\n    __syncwarp();\n",
             "    if (lane == 0) STAMP(b * 5 + 3);\n"),
            ("                    pb[t - 1] = s[q];\n                }\n            }\n"
             "        }\n    }\n",
             "    __syncwarp();\n    if (lane == 0) STAMP(b * 5 + 4);\n"),
        ]),
    ],
    "forward_backward": [
        ("chunked route", 4, ["stage + products", "boundary chain", "replay + stores"], [
            ("    ch.raw0 = ch.raw1 = 0;\n",
             "    if (threadIdx.x == 0) STAMP(blockIdx.x * 4 + 0);\n"),
            ("    // -- phase 2: the boundary chain, v_{c+1}[l] = lse_k(v_c[k] + prod_c[k, l]) --\n",
             "    if (threadIdx.x == 0) STAMP(blockIdx.x * 4 + 1);\n"),
            ("    // -- phase 3: replay the chunk from its boundary, lane = state -------------\n",
             "    if (threadIdx.x == 0) STAMP(blockIdx.x * 4 + 2);\n"),
            ("        const S ll = lse<S, NN>(x);\n        if (lane == 0) ((S*)p.loglik)[b] = ll;\n"
             "    }\n",
             "    __syncthreads();\n    if (threadIdx.x == 0) STAMP(blockIdx.x * 4 + 3);\n"),
        ]),
    ],
    # phases inside a frame loop: cycles summed over the frames, written at
    # the end as running totals from 1 (a stamp of 0 means "not stamped")
    # kernel H: both kernels of the file, the row routes' (smem, global) and
    # the resident route's; a file from before the resident route has the first alone
    # kernel D: the factored kinds' frame (rank-1 partials, the backoff
    # kind's own sources and arcs)
    "factored_forward": [
        ("batched items", D_STRIDE, D_PHASES, D_BATCH_PATCHES),
        ("per-block rank-1 partials", D_STRIDE, D_PHASES, D_PATCHES),
    ],
    "trigram_forward": [
        ("utterances in turn, row routes and resident route", 7, H_PHASES,
         H_BATCH_ROW_PATCHES + H_BATCH_RESIDENT_PATCHES),
        ("row routes and resident route", 7, H_PHASES, H_ROW_PATCHES + H_RESIDENT_PATCHES),
        ("rows owned by history", 7, H_PHASES, H_ROW_PATCHES),
    ],
    # kernel I: the GMM warp's phases a frame and its waits on the ring,
    # the tracker warps' frame loops (the first tracker warp's), each summed
    # by its warp's first lane, then written as running totals by thread 0
    "webrtc_gmm": [
        ("tracker warps and a GMM warp", 8, I_PHASES, [
            ("namespace {\n", "__shared__ unsigned long long ph_sh[8];  // the GMM warp's sums\n"),
            ("    int oh = 0, sr = 0;\n",
             "    if (threadIdx.x == 0) for (int q = 0; q < 8; ++q) ph_sh[q] = 0;\n"),
            ("        // -- the wait for the trackers' stage --\n",
             "        if (threadIdx.x == 0) ph_sh[7] = clock64();\n"),
            ("        bar_wait(&r.full[rs], (st / N_STAGES) & 1);\n",
             "        if (threadIdx.x == 0) ph_sh[3] += clock64() - ph_sh[7];\n"),
            ("                    if (!__all_sync(FULL, ok)) vad = gmm_frame<false>(k, s, x, mvn, "
             "out, ok);\n",
             "                    if (!__all_sync(FULL, ok) && threadIdx.x == 0) ph_sh[5] += 1;\n"),
            ("    const T tiny = (T)1e-38;\n",
             "    if (FAST && threadIdx.x == 0) ph_sh[6] = clock64();\n"),
            ("    const bool vad = any_local || sum_llr >= k.global_thr;\n", _sh(0)),
            ("    // -- the outcome --\n", _sh(1)),
            ("    out.ngm = vad ? ngm1 : ngm0;\n", _sh(2)),
            ("        p.state_i[2] = sr;\n",
             "        for (int q = 0; q < 4; ++q) g_stamps[1000 + q] = ph_sh[q];\n"
             "        g_stamps[1005] = ph_sh[5];\n"),
            ("    int age = 0, fc = 0;\n", "    unsigned long long tr_acc = 0;\n"),
            ("        // -- the tracker's frames --\n",
             "        const unsigned long long tr_t = clock64();\n"),
            ("        bar_arrive(&r.full[s]);\n", "        tr_acc += clock64() - tr_t;\n"),
            ("    if (w == 0 && lane == 0) p.state_i[0] = fc;\n",
             "    if (w == 0 && lane == 0) g_stamps[1004] = tr_acc;\n"),
            ("    if (warp == 0) gmm_warp<T>(p, r); else tracker_warp<T>(p, r, warp - 1);\n",
             "    __syncthreads();\n    if (threadIdx.x == 0) {\n"
             "        unsigned long long c_ = 1;\n        g_stamps[0] = c_;\n"
             "        for (int q = 0; q < 5; ++q) g_stamps[1 + q] = c_ += g_stamps[1000 + q];\n"
             "        g_stamps[6] = g_stamps[1005];  // frames redone with __fdiv_rn\n"
             "    }\n"),
        ]),
        ("one warp, lane = channel", 4, ["decision", "minimum tracker", "adaptation"], [
            ("    int fc = 0, oh = 0, sr = 0;\n",
             "    unsigned long long ph_acc[3] = {0, 0, 0}, ph_t = 0;\n"),
            ("            const bool active = st[i] > T(10);\n", "            ph_t = clock64();\n"),
            ("            const T sgpr[2] = {sgpr0, h1 > T(0) ? O::sub(T(1), sgpr0) : T(0)};\n",
             _acc(0, 12)),
            ("                                    T(16384.0 / 524288.0));\n",
             _acc(1, 12)),
            ("                mv = mv_new;\n                ++fc;\n            }\n",
             _acc(2, 12)),
            ("        p.state_i[2] = sr;\n",
             "        unsigned long long c_ = 1;\n        g_stamps[0] = c_;\n"
             "        for (int q = 0; q < 3; ++q) g_stamps[1 + q] = c_ += ph_acc[q];\n"),
        ]),
    ],
    "ltsd_noise": [
        ("division warps and a combiner warp", J_STRIDE, J_PHASES, [
            # each role's totals, written at its end (before the a phase's own mark)
            ("        publish(sh, (j + 1) & 1, w, sk, sa);\n        lvl = lvl_next;\n    }\n",
             "    if (threadIdx.x == 0) {\n"
             f"        g_stamps[blockIdx.x * {J_STRIDE}] = 1;\n"
             "        for (int q = 0; q < 5; ++q)\n"
             f"            g_stamps[blockIdx.x * {J_STRIDE} + 1 + q] = ph_acc[q];\n"
             "    }\n"),
            ("        if (++s == S) s = 0;\n        prev = flag;\n    }\n",
             "    if (lane == 0) {\n"
             "        for (int q = 0; q < 5; ++q)\n"
             f"            g_stamps[blockIdx.x * {J_STRIDE} + 6 + q] = ph_acc[q];\n"
             f"        g_stamps[blockIdx.x * {J_STRIDE} + 11] = 1;\n"
             "    }\n"),
            # the division warps' frame (warp 0's first lane): the row's wait
            # (and the loop's own work), then the flag's
            ("    int s = 0;         // the stage of the frame divided\n",
             "    unsigned ph_acc[5] = {0, 0, 0, 0, 0}, ph_t = (unsigned)clock64();\n"),
            ("        bar_wait(&sh.full[s], sp);  // frame t + 1's row\n", _acc32(1, 8)),
            ("                yn[k] = adapt ? yda[k] : yn[k];\n            }\n        }\n",
             _acc32(0, 8)),
            ("            sa = k == 0 ? ta : add_rn(sa, ta);\n        }\n", _acc32(2, 8)),
            ("        sa = butterfly(sa);\n", _acc32(3, 8)),
            ("        publish(sh, (j + 1) & 1, w, sk, sa);\n", _acc32(4, 8)),
            # the combiner's frame (its first lane)
            ("    bool ok = true, prev = false;  // prev: the last frame's flag\n",
             "    unsigned ph_acc[5] = {0, 0, 0, 0, 0}, ph_t = (unsigned)clock64();\n"),
            ("        bar_wait(&sh.done[b], (j >> 1) & 1);  // frame t's partials, from every division "
             "warp\n", _acc32(0, 8)),
            ("        const R q = sum_first(sh.part[b][prev], p.warps);\n", _acc32(1, 8)),
            ("        const bool flag = score < c.thr;\n", _acc32(2, 8)),
            ("        bar_arrive(&sh.told[b]);\n", _acc32(3, 8)),
            ("        prev = flag;\n", _acc32(4, 8)),
        ]),
        ("one barrier a frame", 8, J_PHASES_V1, [
            ("        nxt[k] = R(0);\n    }\n",
             "    unsigned ph_acc[7] = {0, 0, 0, 0, 0, 0, 0}, ph_t = 0;\n"),
            ("        R s2 = R(0), s1 = R(0);\n", "        ph_t = (unsigned)clock64();\n"),
            ("            s1 = k == 0 ? cur[k] : add_rn(s1, cur[k]);\n        }\n", _acc32(0, 8)),
            ("        s1 = butterfly(s1);\n", _acc32(1, 8)),
            ("        __syncthreads();  // the other parity's reads finished a frame ago\n",
             _acc32(2, 8)),
            ("            q1 = add_rn(q1, part[par][1][i]);\n        }\n", _acc32(3, 8)),
            ("        if (L == 0) out[t] = score;\n", _acc32(4, 8)),
            ("                if (L + NL * k < F) noise[k] = add_rn(mul_rn(alpha, noise[k]), level);"
             "\n        }\n", _acc32(5, 8)),
            ("        for (int k = 0; k < BINS; ++k) cur[k] = nxt[k];\n",
             _acc32(6, 8) + _final(8, 7, "t == stop - 1", 8)),
        ]),
    ],
    "viterbi_trellis": [
        ("groups of G frames, ballot mask bits, staged rows", K_STRIDE, K_PHASES, [
            ("    R v = on ? add_rn(pi[lane], lb[lane]) : NEG_INF;  // frame 0\n", K_START),
            ("            tree_argmax<0, NMAX>(c, best, arg);\n", _acc32(0, 12)),
            ("            arg = valid ? arg : (k == 0 ? self0 : lane);\n", _acc32(1, 12)),
            ("                bps[k * N + lane] = (int8_t)arg;\n            }\n", _acc32(2, 12)),
            ("            bpg[i] = bps[i];\n        }\n        __syncwarp();\n", _acc32(3, 8)),
            ("        int8_t* bps = ON_CHIP ? bp8 + (size_t)t0 * N : bp8;\n", _acc32(4, 8)),
            ("        mcur = mnxt;\n", _acc32(4, 8)),
            ("    // final state: the first argmax of v (+ log_final); score: its value\n",
             K_FORWARD_END),
        ] + K_BACKTRACE),
        ("mask bytes, stores every step", K_STRIDE, K_PHASES, [
            ("    R v = on ? add_rn(pi[lane], lb[lane]) : NEG_INF;\n", K_START),
            ("            tree_argmax<0, NMAX>(c, best, arg);\n", _acc32(0, 12)),
            ("                nv = v;\n                arg = lane;\n            }\n", _acc32(1, 12)),
            ("                if (bp8) bp8[(size_t)t * N + lane] = (int8_t)arg;\n            }\n",
             _acc32(2, 12)),
            ("            vnxt[k] = (mk && t < Tn) ? mk[t] != 0 : true;\n        }\n", _acc32(4, 8)),
            ("            vcur[k] = vnxt[k];\n        }\n", _acc32(4, 8)),
            ("    // final state: the first argmax of v (+ log_final); score: its value\n",
             K_FORWARD_END),
        ] + K_BACKTRACE),
    ],
}
KERNEL_NAMES = {"A": "mel_frontend", "B": "viterbi", "D": "factored_forward", "G": "forward_backward",
                "H": "trigram_forward", "I": "webrtc_gmm", "J": "ltsd_noise", "K": "viterbi_trellis"}


def stamped_source(src, name):
    """``(source with stamps, (version, stride, phases))`` for the first
    patch set of ``name`` whose anchors all occur once in ``src``."""
    for version, stride, phases, patches in PATCH_SETS[name]:
        if all(src.count(anchor) == 1 for anchor, _ in patches):
            for anchor, text in patches:
                src = src.replace(anchor, anchor + text)
            head = "#include <stdint.h>\n"
            return src.replace(head, head + HEADER, 1) + FOOTER, (version, stride, phases)
    raise SystemExit(f"{name}.cu: no phase patch set matches this source")


def build(nvcc, src_path, out, include):
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", include, "-o", out, src_path]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def event_ms(torch, fn, reps=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default="")
    ap.add_argument("--sass", default="")
    ap.add_argument("--kernels", default="A,B,D,G,H,I,J,K",
                    help="the kernels to split: A, B, D, G, H, I, J, K")
    args = ap.parse_args()
    names = [KERNEL_NAMES[k] for k in args.kernels.split(",")]
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: needs a CUDA GPU", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from lnasr_tpu_torch import _build, entry
    from lnasr_tpu_torch.config import MFCCConfig
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import trellis as tr
    from lnasr_tpu_torch.ops import viterbi as vt
    from lnasr_tpu_torch.vad import webrtc as tweb

    card = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    tag = os.path.basename(root.rstrip("/"))
    work = os.path.join(WORK, tag)
    os.makedirs(work, exist_ok=True)
    nvcc = _build._nvcc()
    procs, versions = {}, {}
    for name in names:
        with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
            src, versions[name] = stamped_source(f.read(), name)
        path = os.path.join(work, f"{name}_stamped.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = build(nvcc, path, os.path.join(work, f"{name}_stamped.so"), _build.CSRC)
    _build.build_all()  # the unstamped kernels: the stamps' cost, and the SASS
    from lnasr_tpu_torch.vad import ltsd

    argtypes = {"mel_frontend": mf._ARGTYPES, "viterbi": vt._ARGTYPES,
                "forward_backward": tr._ARGTYPES, "webrtc_gmm": tweb._GMM_ARGTYPES,
                "ltsd_noise": ltsd._ARGTYPES, "viterbi_trellis": tr._VITERBI_ARGTYPES}
    if "trigram_forward" in names:
        from lnasr_tpu_torch.ops import trigram as tri

        argtypes["trigram_forward"] = tri._FWD_ARGTYPES
    if "factored_forward" in names:
        from lnasr_tpu_torch.ops import factored as F

        argtypes["factored_forward"] = F._FWD_ARGTYPES
    stamped, plain = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the stamped {name}.cu:\n{log}")
        lib = ctypes.CDLL(os.path.join(work, f"{name}_stamped.so"))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes, launch.restype = argtypes[name], ctypes.c_int
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        stamped[name] = lib
        plain[name] = _build.load(name, argtypes[name])
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        for name in names:
            sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
                                   _build.library_path(name)], capture_output=True, text=True)
            with open(os.path.join(args.sass, f"{tag}_{name}.sass"), "w") as f:
                f.write(sass.stdout + sass.stderr)

    rows = []

    def emit(**row):
        row = {"root": root, "card": card, **row}
        rows.append(row)
        print(json.dumps(row), flush=True)

    def use(name, lib):
        """Point the checkout's wrapper at ``lib`` (stamped or not)."""
        _build._loaded[name] = lib

    def split(name, call):
        """Mean cycles of each phase over the units (blocks or warps) that
        stamped every boundary, their shares, and a unit's mean total."""
        version, stride, phases = versions[name]
        lib = stamped[name]
        use(name, lib)
        torch.cuda.synchronize()
        lib.clear_stamps()
        call()
        torch.cuda.synchronize()
        stamps = np.zeros(N_STAMPS, np.uint64)
        rc = lib.read_stamps(stamps.ctypes.data, N_STAMPS)
        if rc:
            raise SystemExit(f"read_stamps failed: cudaError {rc}")
        units = stamps[: N_STAMPS // stride * stride].reshape(-1, stride)
        if version in RAW:  # each phase's own total between the two markers
            units = units[(units[:, 0] == 1) & (units[:, len(phases) + 1] == 1)].astype(np.int64)
            d = units[:, 1:len(phases) + 1]
        else:
            units = units[:, : len(phases) + 1]
            units = units[(units != 0).all(1)].astype(np.int64)
            d = np.diff(units, axis=1)
        if not len(units):
            raise SystemExit(f"{name}: no block or warp stamped every boundary ({version})")
        mean = d.mean(0)
        return dict(version=version, units=len(units), first_row=stamps[:stride].tolist(),
                    cycles={p: float(c) for p, c in zip(phases, mean)},
                    shares={p: float(c / mean.sum()) for p, c in zip(phases, mean)},
                    unit_cycles=float(d.sum(1).mean()))

    def times(name, call):
        use(name, stamped[name])
        st = event_ms(torch, call)
        use(name, plain[name])
        return dict(stamped_ms=st, unstamped_ms=event_ms(torch, call))

    dev = torch.device("cuda")
    cfg = MFCCConfig()
    rng = np.random.default_rng(0)
    for what, b, s in (("flagship B=64 x 10 s", 64, 160000), ("segment B=1, T=511", 1, 82000)
                       ) if "mel_frontend" in names else ():
        y = torch.as_tensor(rng.normal(scale=3000.0, size=(b, s)).astype(np.float32), device=dev)
        call = lambda: mf._launch(y, cfg)  # noqa: E731
        res = split("mel_frontend", call)
        use("mel_frontend", plain["mel_frontend"])
        mel_k, en_k = call()
        mel_p, en_p = mf.mel_frontend_plain(y, cfg)
        scale = float(en_p.max())
        if not bool(((mel_k - mel_p).abs() <= 2e-6 * scale + 1e-4 * mel_p.abs()).all()):
            raise SystemExit(f"kernel A off its bar at {what}")
        emit(kernel="A", what=what, **res, **times("mel_frontend", call))

    def sm_clock():
        return subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=clocks.sm",
                               "--format=csv,noheader,nounits"], capture_output=True, text=True,
                              timeout=60).stdout.strip()

    def trellis_inputs(b, t, n):
        log_pi = torch.as_tensor(np.log(rng.dirichlet(np.ones(n))).astype(np.float32), device=dev)
        log_a = torch.as_tensor(np.log(rng.dirichlet(np.ones(n), size=n)).astype(np.float32),
                                device=dev)
        log_b = torch.as_tensor(rng.normal(scale=3.0, size=(b, t, n)).astype(np.float32),
                                device=dev)
        return log_pi, log_a, log_b

    if "viterbi" in names:
        b, t, n = 64, 999, 5
        log_pi, log_a, log_b = trellis_inputs(b, t, n)
        call = lambda: vt._launch(log_pi, log_a, log_b)  # noqa: E731
        res = split("viterbi", call)
        use("viterbi", stamped["viterbi"])
        path, score = call()
        ref = vt.viterbi_plain(log_pi, log_a, log_b)
        if not (torch.equal(path, ref[0]) and torch.equal(score, ref[1])):
            raise SystemExit("the stamped kernel B differs from the plain scan")
        emit(kernel="B", what=f"flagship B={b}, T={t}, N={n}", **res,
             cycles_per_forward_step=res["cycles"]["forward"] / (t - 1),
             **times("viterbi", call), sm_clock_mhz=sm_clock())
    for n in (5, 8) if "forward_backward" in names else ():
        b, t = 64, 999
        args_g = trellis_inputs(b, t, n) + (torch.ones((b, t), dtype=torch.bool, device=dev),)
        call = lambda: tr._launch(*args_g, 3, route="chunked")  # noqa: E731
        res = split("forward_backward", call)
        got = call()
        use("forward_backward", plain["forward_backward"])
        ref = call()
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise SystemExit("the stamped kernel G differs from the unstamped one")
        c, chunk = tr.fb_chunks(t)
        steps = dict(zip(res["cycles"], (chunk, c, chunk)))
        emit(kernel="G", what=f"chunked route B={b}, T={t}, N={n}, {c} chunks of {chunk}", **res,
             cycles_per_step={p: res["cycles"][p] / k for p, k in steps.items()},
             **times("forward_backward", call), sm_clock_mhz=sm_clock())
    if "trigram_forward" in names:
        rec, seg = entry.recognizer_serving(200, device=dev, graph="trigram", lm_order=3)
        g = rec.graph
        padded, n, _ = rec._pad_to_bucket(seg)
        feats, mask = rec.am.mfcc.features_fast(torch.from_numpy(padded).to(dev),
                                                lengths=torch.tensor([n], device=dev))
        args32 = (g._grid_log_b(feats), mask, g.inner_a, g.hop3, g.log_pi_w, g.final3,
                  g._exit_idx32)
        args64 = tuple(x.double() if x.is_floating_point() else x for x in args32)
        t, v, s = args32[0].shape
        steps = int(mask[1:].sum())
        n_sm = tri.sm_count(dev)
        fits = getattr(tri, "route_fits", None)
        for what, args_h in (("float32", args32), ("float64", args64)):
            isz = args_h[0].dtype.itemsize
            for route in tri.ROUTES:
                if fits is not None and not fits(route, v + 1, v, s, isz, n_sm):
                    continue
                call = lambda: tri._forward(*args_h, route=route)  # noqa: E731
                res = split("trigram_forward", call)
                got = call()
                use("trigram_forward", plain["trigram_forward"])
                ref = call()
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise SystemExit(f"the stamped kernel H differs from the unstamped one "
                                     f"({what}, {route})")
                emit(kernel="H", what=f"forward V=200, T={t}, {steps} valid steps, {what}",
                     route=route, chosen=route == tri.trigram_route(v + 1, v, s, isz, n_sm),
                     **res, cycles_per_step={p: c / steps for p, c in res["cycles"].items()
                                             if p not in ("load", "final argmax")},
                     **times("trigram_forward", call), sm_clock_mhz=sm_clock())
    if "factored_forward" in names:
        import chip_smoke

        rec, seg = entry.recognizer_serving(5000, device=dev)
        padded, n, _ = rec._pad_to_bucket(seg)
        feats, mask = rec.am.mfcc.features_fast(torch.from_numpy(padded).to(dev),
                                                lengths=torch.tensor([n], device=dev))
        g = rec.graph
        h = g._kernel_hop
        cases = [("V=5000 segment, backoff hop", g, h, *g._grid_inputs(feats)[:2], mask),
                 ("V=5000 segment, rank-1 hop", g, F.Rank1Hop(h.from_w, h.uni, h.sil_from,
                                                              h.sil_idx),
                  *g._grid_inputs(feats)[:2], mask)]
        for vocab in (5000, 10000):
            gb, frames = chip_smoke.backoff_bench_graph(torch, dev, vocab, 500)
            lb, pi = gb._grid_inputs(frames)[:2]
            cases.append((f"bench V={vocab}, backoff hop", gb, gb._kernel_hop, lb, pi, None))
        for what, gi, hop, lb, pi, m in cases:
            d_args = (pi, gi.inner_a, gi.exit_idx, hop, lb, m)
            call = lambda: F.factored_forward(*d_args)  # noqa: E731
            res = split("factored_forward", call)
            got = call()
            use("factored_forward", plain["factored_forward"])
            ref = call()
            if not (torch.equal(got.view(torch.int32), ref.view(torch.int32)) and torch.equal(
                    ref.view(torch.int32), F.factored_forward_plain(*d_args).view(torch.int32))):
                raise SystemExit(f"the stamped kernel D differs ({what})")
            steps = lb.shape[0] - 1 if m is None else int(m[1:].sum())
            lay = F.block_layout(hop, lb.shape[2], F.sm_count(dev))
            emit(kernel="D", what=f"{what}, T={lb.shape[0]}, {steps} valid steps", **res,
                 cycles_per_step={p: c / steps for p, c in res["cycles"].items()},
                 blocks=lay.n_blocks if lay else None, max_src=lay.max_src if lay else 0,
                 **times("factored_forward", call), sm_clock_mhz=sm_clock())
    if "webrtc_gmm" in names:
        audio = entry.serving_stream(0)
        n = len(audio) // tweb.FRAME_LEN_16K
        sig = torch.as_tensor(audio, device=dev)
        feats, total, _ = tweb.extract_features(sig[: n * tweb.FRAME_LEN_16K].to(torch.float32),
                                                tweb.initial_filter_state(torch.float32, dev))
        call = lambda: tweb.gmm_flags(feats, total, tweb.MODE_TABLE[0])  # noqa: E731
        res = split("webrtc_gmm", call)
        got = tweb.gmm_flags(feats, total, tweb.MODE_TABLE[0], final_state=True)
        use("webrtc_gmm", plain["webrtc_gmm"])
        ref = tweb.gmm_flags(feats, total, tweb.MODE_TABLE[0], final_state=True)
        same = torch.equal(got[0], ref[0]) and all(
            torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                        b.view(torch.int32) if b.is_floating_point() else b)
            for a, b in zip(got[1], ref[1]))
        if not same:
            raise SystemExit("the stamped kernel I differs from the unstamped one")
        row = dict(kernel="I", what=f"mode 0, {n} frames", **res,
                   cycles_per_frame={p: c / n for p, c in res["cycles"].items()})
        if res["version"] == "tracker warps and a GMM warp":  # the trackers run beside it
            chain = {p: res["cycles"][p] for p in I_PHASES[:4]}
            row["shares"] = {p: c / sum(chain.values()) for p, c in chain.items()}
            row["active_frames"] = int((total > 10).sum())
            row["frames_redone"] = int(res["first_row"][6])  # with __fdiv_rn
        emit(**row, **times("webrtc_gmm", call), sm_clock_mhz=sm_clock())
    if "ltsd_noise" in names:
        from lnasr_tpu_torch.config import LTSDConfig

        cfg_j = LTSDConfig(alpha=0.4)
        sig = torch.as_tensor(entry.serving_stream(0).astype(np.float64) / 32768.0, device=dev)
        amps = ltsd._amplitudes(sig, cfg_j, torch.float32)
        ltse, noise = ltsd._ltse(amps, cfg_j.order), amps[:2].mean(dim=0) ** 2
        call = lambda: ltsd._launch(ltse, noise, cfg_j)  # noqa: E731
        res = split("ltsd_noise", call)
        got = call()
        use("ltsd_noise", plain["ltsd_noise"])
        ref = call()
        nan = torch.isnan(ref)
        if not (torch.equal(nan, torch.isnan(got)) and torch.equal(
                torch.where(nan, 0.0, got).view(torch.int32),
                torch.where(nan, 0.0, ref).view(torch.int32))):
            raise SystemExit("the stamped kernel J differs from the unstamped one")
        if not torch.equal(torch.where(nan, 0.0, ref).view(torch.int32), torch.where(
                nan, 0.0, ltsd.ltsd_noise_plain(ltse, noise, cfg_j)).view(torch.int32)):
            raise SystemExit("kernel J differs from its plain loop")
        t, f = ltse.shape
        frames = t - 2 * cfg_j.order
        per_frame = {p: c / frames for p, c in res["cycles"].items()}
        row = dict(kernel="J", what=f"stream, {frames} valid frames x {f} bins, float32, "
                   f"{ltsd.ltsd_warps(f)} warps", **res, cycles_per_frame=per_frame)
        if res["version"] in RAW:  # the two roles run side by side: a frame each
            row["division_cycles_per_frame"] = sum(list(per_frame.values())[:5])
            row["combiner_cycles_per_frame"] = sum(list(per_frame.values())[5:])
        emit(**row, **times("ltsd_noise", call), sm_clock_mhz=sm_clock())
    if "viterbi_trellis" in names:
        model = entry.flagship_model(dev)
        feats = entry.training(device=dev).features
        b, t, _ = feats.shape
        lengths = np.random.default_rng(17).integers(t // 3, t + 1, size=b)
        lengths[0] = t
        mask = torch.as_tensor(np.arange(t)[None, :] < lengths[:, None], device=dev)
        args_k = (model.log_pi, model.log_a, model.emissions(feats), mask)
        call = lambda: tr._viterbi_launch(*args_k)  # noqa: E731
        res = split("viterbi_trellis", call)
        got = call()
        use("viterbi_trellis", plain["viterbi_trellis"])
        ref = call()
        same = lambda x, y: all(  # noqa: E731
            torch.equal(u.view(torch.int32) if u.is_floating_point() else u,
                        w.view(torch.int32) if w.is_floating_point() else w) for u, w in zip(x, y))
        if not same(got, ref):
            raise SystemExit("the stamped kernel K differs from the unstamped one")
        if not same(ref, tr.viterbi_scan_plain(*args_k)):
            raise SystemExit("kernel K differs from its plain loop")
        emit(kernel="K", what=f"decode_batch's inputs B={b}, T={t}, N={args_k[2].shape[-1]}, "
             f"ragged masks", **res,
             cycles_per_step={p: c / (t - 1) for p, c in res["cycles"].items()},
             **times("viterbi_trellis", call), sm_clock_mhz=sm_clock())
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
