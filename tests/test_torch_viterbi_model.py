"""A NumPy model of the small-N Viterbi kernel (``csrc/viterbi.cu``),
held bitwise against its plain version and the JAX package's scan.

The CUDA kernel cannot run here, so what makes it differ from the scan
runs here instead: each step's (value, index) tree argmax over the
candidates (padded with -inf to 16 or 32 above N = 8), the final xor
shuffle argmax, the capacity rule that puts the backpointers in shared
memory or in device memory, and the backtrace by composed chunk maps
(walks of every chunk from each end state, one lane composing the maps,
the chunks walked again in parallel) at chunk lengths K of 1, 5 and 32.
Max is exact and the model follows indices only, so paths and scores must
equal the scan's bit for bit, ties and -inf columns included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.ops.trellis import viterbi_scan as j_viterbi_scan
from lnasr_tpu_torch.ops.viterbi import (
    BACKTRACE_CHUNK,
    BP_SMEM_BYTES,
    viterbi_plain,
    viterbi_smem_ok,
)

_J_SCAN = jax.jit(jax.vmap(j_viterbi_scan, in_axes=(None, None, 0, 0, None)))
T_GRID = (1, 2, 31, 32, 33, 200)
N_GRID = (1, 2, 5, 8, 9, 16, 32)
KINDS = ("random", "ties", "left_to_right", "column")


def _model_graph(rng, n, kind):
    """``(log_pi, log_a)``: random; all tied; a left-to-right band with
    -inf off it; random with one target (an all--inf column of log_a) that
    no state reaches."""
    if kind == "ties":
        return np.zeros(n, np.float32), np.zeros((n, n), np.float32)
    if kind == "left_to_right":
        with np.errstate(divide="ignore"):
            log_a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
        log_a[-1, -1] = 0.0
        log_pi = np.full(n, -np.inf)
        log_pi[0] = 0.0
        return log_pi.astype(np.float32), log_a.astype(np.float32)
    log_pi = np.log(rng.dirichlet(np.ones(n))).astype(np.float32)
    log_a = np.log(rng.dirichlet(np.ones(n), size=n)).astype(np.float32)
    if kind == "column" and n > 1:
        log_a[:, n // 2] = -np.inf
    return log_pi, log_a


def _emissions(rng, b, t, n, kind):
    lb = rng.normal(scale=2.0, size=(b, t, n)).astype(np.float32)
    return np.round(lb) if kind == "ties" else lb


def candidates(n):
    """Candidates a kernel step takes: N itself up to 8 (a template
    argument), else 16 or 32 with the states past N at -inf."""
    return n if n <= 8 else (16 if n <= 16 else 32)


def tree_argmax(c, lo, hi):
    """The kernel's balanced tree over ``c[..., lo:hi]``: the higher half
    wins only where strictly larger, so ties keep the lower index."""
    if hi - lo == 1:
        return c[..., lo], np.full(c.shape[:-1], lo, np.int64)
    mid = lo + (hi - lo + 1) // 2
    lv, li = tree_argmax(c, lo, mid)
    rv, ri = tree_argmax(c, mid, hi)
    right = rv > lv
    return np.where(right, rv, lv), np.where(right, ri, li)


def tree_depth(n):
    return 0 if n == 1 else 1 + tree_depth((n + 1) // 2)


def shuffle_argmax(v):
    """The kernel's final argmax: an xor butterfly over 32 lanes of
    (value, index) pairs, lanes past N at -inf."""
    b, n = v.shape
    bv = np.full((b, 32), -np.inf, np.float32)
    bv[:, :n] = v
    bi = np.broadcast_to(np.arange(32), (b, 32)).copy()
    for off in (16, 8, 4, 2, 1):
        ov, oi = bv[:, np.arange(32) ^ off], bi[:, np.arange(32) ^ off]
        take = (ov > bv) | ((ov == bv) & (oi < bi))
        bv, bi = np.where(take, ov, bv), np.where(take, oi, bi)
    return bv[:, 0], bi[:, 0]


def chunk_backtrace(bp, last, k):
    """The kernel's backtrace of one utterance from its backpointers ``bp
    (T, N)`` and final state: chunk c covers steps (cK, min((c+1)K, T-1)];
    (1) every chunk walked from each end state e to its start state,
    maps[c, e]; (2) the chunks' end states composed from the last frame
    back; (3) the chunks walked again from those, writing the path.
    Returns ``(path, depth)``, depth the dependent loads of the three
    phases."""
    t_len, n = bp.shape
    n_chunks = -(-(t_len - 1) // k)
    tops = [min((c + 1) * k, t_len - 1) for c in range(n_chunks)]
    maps = np.zeros((n_chunks, n), np.int64)
    for c in range(n_chunks):
        for e in range(n):
            s = e
            for t in range(tops[c], c * k, -1):
                s = bp[t, s]
            maps[c, e] = s
    ends = np.zeros(n_chunks, np.int64)
    if n_chunks:
        ends[-1] = last
        for c in range(n_chunks - 1, 0, -1):
            ends[c - 1] = maps[c, ends[c]]
    path = np.zeros(t_len, np.int64)
    path[-1] = last
    for c in range(n_chunks):
        s = ends[c]
        for t in range(tops[c], c * k, -1):
            s = bp[t, s]
            path[t - 1] = s
    walks = -(-n_chunks * n // 32)  # walks a lane, interleaved: one chain of k loads
    depth = (k if walks else 0) + max(n_chunks - 1, 0) + (k if n_chunks else 0)
    return path, depth


def kernel_model(log_pi, log_a, log_b, k=BACKTRACE_CHUNK):
    """The kernel on ``log_b (B, T, N)``: ``(path, score, on_chip, depth)``."""
    b, t_len, n = log_b.shape
    nc = candidates(n)
    a = np.full((nc, n), -np.inf, np.float32)
    a[:n] = log_a
    v = (log_pi[None, :] + log_b[:, 0]).astype(np.float32)
    bp = np.zeros((b, t_len, n), np.int64)
    for t in range(1, t_len):
        vc = np.full((b, nc), -np.inf, np.float32)
        vc[:, :n] = v
        cand = vc[:, :, None] + a[None]  # (B, i, j): v[i] + a[i, j], fp32
        best, arg = tree_argmax(np.moveaxis(cand, 1, 2), 0, nc)
        v = best + log_b[:, t]
        bp[:, t] = arg
    score, last = shuffle_argmax(v)
    paths, depths = zip(*(chunk_backtrace(bp[i], last[i], k) for i in range(b)))
    return np.stack(paths).astype(np.int32), score, viterbi_smem_ok(t_len, n), depths[0]


def _jax(log_pi, log_a, log_b):
    mask = np.ones(log_b.shape[:2], bool)
    res = _J_SCAN(*(jnp.asarray(x) for x in (log_pi, log_a, log_b, mask,
                                              np.zeros(log_b.shape[-1], np.float32))))
    return np.asarray(res.path), np.asarray(res.score)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", N_GRID)
def test_kernel_model_bitwise(n, kind):
    """Every T of the grid and K of 1, 5 and 32: paths and scores bitwise
    those of ``viterbi_plain`` and of the JAX scan."""
    for t_len in T_GRID:
        rng = np.random.default_rng([n, t_len, KINDS.index(kind)])
        log_pi, log_a = _model_graph(rng, n, kind)
        log_b = _emissions(rng, 3, t_len, n, kind)
        ref_path, ref_score = viterbi_plain(*(torch.as_tensor(x) for x in (log_pi, log_a, log_b)))
        j_path, j_score = _jax(log_pi, log_a, log_b)
        np.testing.assert_array_equal(ref_path.numpy(), j_path)
        np.testing.assert_array_equal(ref_score.numpy(), j_score)
        for k in (1, 5, 32):
            path, score, _, _ = kernel_model(log_pi, log_a, log_b, k)
            np.testing.assert_array_equal(path, ref_path.numpy(), err_msg=f"T={t_len} K={k}")
            np.testing.assert_array_equal(score, ref_score.numpy(), err_msg=f"T={t_len} K={k}")


def test_tree_argmax_is_first_index_argmax():
    """The tree's (value, index) rule picks torch.max's first index on
    heavy ties, -inf columns included, at every candidate count."""
    rng = np.random.default_rng(4)
    for n in range(1, 33):
        c = np.round(rng.normal(size=(500, n))).astype(np.float32)
        c[:50] = -np.inf
        c[50:100, : n // 2] = -np.inf
        best, arg = tree_argmax(c, 0, n)
        ref_best, ref_arg = torch.max(torch.as_tensor(c), dim=-1)
        np.testing.assert_array_equal(best, ref_best.numpy())
        np.testing.assert_array_equal(arg, ref_arg.numpy())
    assert [tree_depth(n) for n in (1, 2, 5, 8, 16, 32)] == [0, 1, 3, 3, 4, 5]


def test_capacity_rule_and_global_route():
    """Backpointers stay on chip up to ``BP_SMEM_BYTES`` int8 a step times
    N; past it the kernel takes the device-memory route, which the model
    (and the kernel) back-traces by the same chunk maps."""
    assert viterbi_smem_ok(999, 5) and viterbi_smem_ok(BP_SMEM_BYTES // 32, 32)
    assert not viterbi_smem_ok(BP_SMEM_BYTES // 32 + 1, 32)
    assert viterbi_smem_ok(BP_SMEM_BYTES // 5, 5) and not viterbi_smem_ok(BP_SMEM_BYTES // 5 + 1, 5)
    rng = np.random.default_rng(8)
    n, t_len = 32, BP_SMEM_BYTES // 32 + 7
    log_pi, log_a = _model_graph(rng, n, "random")
    log_b = _emissions(rng, 1, t_len, n, "ties")
    path, score, on_chip, depth = kernel_model(log_pi, log_a, log_b)
    ref_path, ref_score = viterbi_plain(*(torch.as_tensor(x) for x in (log_pi, log_a, log_b)))
    assert not on_chip
    np.testing.assert_array_equal(path, ref_path.numpy())
    np.testing.assert_array_equal(score, ref_score.numpy())
    assert depth == 2 * BACKTRACE_CHUNK + -(-(t_len - 1) // BACKTRACE_CHUNK) - 1


def test_backtrace_depth_at_the_serving_shape():
    """At the serving step's T = 999, N = 5 the three phases' dependent
    loads are 2K + ceil((T - 1) / K) - 1 = 95, against T - 1 = 998 for a
    frame-by-frame walk."""
    rng = np.random.default_rng(9)
    log_pi, log_a = _model_graph(rng, 5, "random")
    log_b = _emissions(rng, 2, 999, 5, "random")
    path, score, on_chip, depth = kernel_model(log_pi, log_a, log_b)
    ref_path, ref_score = viterbi_plain(*(torch.as_tensor(x) for x in (log_pi, log_a, log_b)))
    np.testing.assert_array_equal(path, ref_path.numpy())
    np.testing.assert_array_equal(score, ref_score.numpy())
    assert on_chip and depth == 95
