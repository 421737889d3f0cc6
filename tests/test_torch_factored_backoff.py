"""The exact backoff search's CPU paths: the plain versions of kernels D, E
and F (``ops/factored.py``) with the backoff hop as a CSR of its finite
arcs (``BackoffHop``) against the JAX package's jitted
``factored_trellis_scan``, ``factored_lattice_scan`` and ``_hop_entry`` on
the same padded ``HopFactors``.

The factors are drawn at random, so that the cases reach what a built
graph rarely does: rows with no arcs, arcs scored ``-inf``, a graph with no
silence word, K = 1 to 8, exact ties between two arcs' ``exit + val`` and
between the rank-1 and the sparse families (arcs scored at their own
backoff estimate, integer scores), starts that are all ``-inf``, masks with
the last frame masked, T = 1. Max-plus is exact and both sides take the
lowest achieving source, so paths, scores and records are bitwise equal
at float32 and float64. One jitted JAX function serves every case of a
shape. (A small ``Recognizer`` with ``hop_mode="backoff"`` against the JAX
recognizer is in ``test_torch_recognizer.py``, beside its units.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.models import decoder as jdec
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.ops import factored as F

_SCAN = jax.jit(jdec.factored_trellis_scan)
_LATTICE = jax.jit(jdec.factored_lattice_scan)
_ENTRY = jax.jit(jdec._hop_entry)


def _factors(rng, v, k, sil, ties):
    """Random padded factors ``(from_w, uni, sil_from, sil_idx, pred,
    val)`` as float64 NumPy: rows of 0 to ``k`` arcs (sources ascending,
    padding ``pred`` 0 and ``val`` -inf), some arcs scored -inf, some at
    their own backoff estimate ``from_w[src] + uni[dst]``; with ``ties``
    every score is an integer."""
    def draw(n):
        x = rng.normal(scale=2.0, size=n)
        return np.round(x) if ties else x

    from_w, uni = draw(v), draw(v)
    sil_idx = v - 1 if sil else -1
    sil_from = np.full(v, -np.inf)
    if sil:
        sil_from = draw(v)
        sil_from[sil_idx] = -np.inf
        uni[sil_idx] = -np.inf
    pred = np.zeros((v, k), np.int32)
    val = np.full((v, k), -np.inf)
    for w in range(v):
        n = int(rng.integers(0, k + 1))  # 0: a row with no arcs
        src = np.sort(rng.choice(v, size=n, replace=False))
        x = from_w[src] + uni[w] + np.abs(draw(n))
        at_estimate = rng.random(n) < 0.3
        x[at_estimate] = from_w[src[at_estimate]] + uni[w]
        x[rng.random(n) < 0.15] = -np.inf
        pred[w, :n], val[w, :n] = src, x
    return from_w, uni, sil_from, sil_idx, pred, val


def _case(v, s, k, t_len, sil, ties, dtype, seed, mask_kind="gaps", dead_start=False):
    """One case's inputs: ``(numpy arrays, JAX HopFactors, port padded
    factors, port BackoffHop)``."""
    rng = np.random.default_rng(seed)
    from_w, uni, sil_from, sil_idx, pred, val = _factors(rng, v, k, sil, ties)
    inner = np.full((v, s, s), -np.inf)
    exit_idx = rng.integers(1, s + 1, size=v) - 1
    for w in range(v):
        n = exit_idx[w] + 1
        for j in range(n):
            inner[w, j, j] = np.log(0.5) if not ties else -1.0
            if j + 1 < n:
                inner[w, j, j + 1] = np.log(0.5) if not ties else -1.0
    log_b = rng.normal(scale=3.0, size=(t_len, v, s))
    if ties:
        log_b = np.round(log_b)
    pi = np.full((v, s), -np.inf)
    if not dead_start:
        pi[:, 0] = np.round(rng.normal(size=v)) if ties else rng.normal(size=v)
    final = np.where(np.arange(s)[None] == exit_idx[:, None], 0.0, -np.inf)
    mask = np.ones(t_len, bool)
    if mask_kind == "gaps" and t_len > 3:
        mask[[1, t_len // 2, t_len - 1]] = False  # the last frame masked too
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    arrays = dict(log_b=log_b.astype(np_dt), inner=inner.astype(np_dt), pi=pi.astype(np_dt),
                  final=final.astype(np_dt), exit_idx=exit_idx.astype(np.int32), mask=mask)
    j_hop = jdec.HopFactors(
        from_w=jnp.asarray(from_w.astype(np_dt)), uni=jnp.asarray(uni.astype(np_dt)),
        sil_from=jnp.asarray(sil_from.astype(np_dt)), sil_idx=jnp.int32(sil_idx),
        pred=jnp.asarray(pred), val=jnp.asarray(val.astype(np_dt)))
    padded = tdec.HopFactors(
        from_w=torch.as_tensor(from_w, dtype=dtype), uni=torch.as_tensor(uni, dtype=dtype),
        sil_from=torch.as_tensor(sil_from, dtype=dtype), sil_idx=sil_idx,
        pred=torch.as_tensor(pred), val=torch.as_tensor(val, dtype=dtype))
    return arrays, j_hop, padded, F.backoff_hop(padded)


CASES = [  # (V, S, K, T, silence, ties, mask, dead start): four shapes, one compile each
    (6, 3, 1, 17, True, False, "gaps", False),
    (11, 4, 4, 29, False, False, "gaps", False),
    (11, 4, 4, 29, True, True, "gaps", False),
    (11, 4, 4, 29, True, False, "gaps", True),
    (40, 2, 8, 23, True, True, "gaps", False),
    (40, 2, 8, 23, False, True, "none", False),
    (7, 3, 2, 1, True, False, "none", False),  # T = 1
]
DTYPES = [torch.float32, torch.float64]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype == np.float32 else np.int64) if x.dtype.kind == "f" else x


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "V{}S{}K{}T{}{}{}{}".format(
    *c[:4], "-sil" * c[4], "-ties" * c[5], "-dead" * c[7]))
def test_plain_d_e_f_bitwise_vs_jax_scans(case, dtype):
    """D and E (the plain forward and replay) with the CSR hop give the JAX
    jitted ``factored_trellis_scan``'s path and score, D's grids are those
    of the plain forward on the padded rows, and F (the plain lattice
    forward) gives the JAX ``factored_lattice_scan``'s three record arrays
    and its last grid, all bit for bit."""
    v, s, k, t_len, sil, ties, mask_kind, dead = case
    a, j_hop, padded, hop = _case(v, s, k, t_len, sil, ties, dtype, seed=v * 7 + k,
                                  mask_kind=mask_kind, dead_start=dead)
    assert F.hop_kind(hop) == "backoff" and hop.arc_val.dtype == dtype
    t = {n: torch.as_tensor(x) for n, x in a.items()}
    j = {n: jnp.asarray(x) for n, x in a.items()}
    if t_len == 1:  # the JAX decode refuses T = 1: the frame plus a masked one
        j_path, j_score = _SCAN(jnp.concatenate([j["log_b"]] * 2), j["inner"], j_hop, j["pi"],
                                j["final"], j["exit_idx"], jnp.asarray([True, False]))
        j_path = j_path[:1]
    else:
        j_path, j_score = _SCAN(j["log_b"], j["inner"], j_hop, j["pi"], j["final"],
                                j["exit_idx"], j["mask"])
    grids = F.factored_forward(t["pi"], t["inner"], t["exit_idx"], hop, t["log_b"], t["mask"])
    ref = F.factored_forward(t["pi"], t["inner"], t["exit_idx"], padded, t["log_b"], t["mask"])
    np.testing.assert_array_equal(_bits(grids.numpy()), _bits(ref.numpy()))
    path, score = F.factored_backtrace(grids, t["inner"], t["exit_idx"], hop, t["final"],
                                       t["mask"])
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
    np.testing.assert_array_equal(_bits(score.numpy()), _bits(j_score))
    recs = F.factored_lattice(t["pi"], t["inner"], t["exit_idx"], hop, t["log_b"], t["mask"])
    j_recs = _LATTICE(j["log_b"], j["inner"], j_hop, j["pi"], j["exit_idx"], j["mask"])
    for got, want in zip(recs, j_recs):
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    _, _, _, v_last = F.factored_lattice_scan(t["log_b"], t["inner"], hop, t["pi"],
                                              t["exit_idx"], t["mask"])
    np.testing.assert_array_equal(_bits(v_last.numpy()), _bits(j_recs[3]))
    assert (F.factored_forward.launches, F.factored_backtrace.launches,
            F.factored_lattice.launches) == (0, 0, 0)
    if dead:
        assert not np.isfinite(grids.numpy()).any()


def test_cases_reach_ties_empty_rows_and_hops():
    """The cases hold what they are there for: rows with no arcs, arcs the
    CSR drops (-inf), exact ties between two arcs and between the families,
    and hops taken along the decoded paths."""
    empty = dropped = arc_ties = family_ties = hops = 0
    for v, s, k, t_len, sil, ties, mask_kind, dead in CASES:
        a, _, padded, hop = _case(v, s, k, t_len, sil, ties, torch.float32, seed=v * 7 + k,
                                  mask_kind=mask_kind, dead_start=dead)
        empty += int((np.diff(hop.arc_ptr.numpy()) == 0).sum())
        dropped += int(np.isneginf(padded.val.numpy()).sum()
                       - (padded.val.shape[0] * padded.val.shape[1] - len(hop.arc_src)))
        if t_len < 2 or dead:
            continue
        t = {n: torch.as_tensor(x) for n, x in a.items()}
        grids = F.factored_forward(t["pi"], t["inner"], t["exit_idx"], hop, t["log_b"], t["mask"])
        path, _ = F.factored_backtrace(grids, t["inner"], t["exit_idx"], hop, t["final"],
                                       t["mask"])
        hops += int((path[1:] // s != path[:-1] // s).sum())
        for tt in range(t_len):
            ex = grids[tt, torch.arange(v), t["exit_idx"].long()]
            cand = ex[hop.arc_src.long()] + hop.arc_val
            dst = hop.arc_dst.numpy()
            for w in range(v):
                row = cand.numpy()[dst == w]
                if len(row) and np.isfinite(row.max()):
                    arc_ties += int((row == row.max()).sum() > 1)
            entry_r1 = torch.max(ex + hop.from_w) + hop.uni
            sp = torch.full((v,), -np.inf).scatter_reduce(0, hop.arc_dst.long(), cand, "amax")
            family_ties += int(((entry_r1 == sp) & torch.isfinite(sp)).sum())
    assert empty > 0 and hops > 0 and arc_ties > 0 and family_ties > 0
    assert dropped >= 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("sil", [True, False])
def test_hop_entry_values_and_sources_vs_jax(dtype, sil):
    """``hop_entry`` with the CSR gives the JAX ``_hop_entry``'s values
    everywhere and its sources wherever the entry is finite (the only
    places a source is read), on random exits, all-zero exits (every
    family and every arc of a row tied), exits with ``-inf`` holes and
    all-``-inf`` exits; with the padded rows it gives the JAX sources
    everywhere."""
    _, j_hop, padded, hop = _case(31, 3, 6, 2, sil, True, dtype, seed=3)
    rng = np.random.default_rng(4)
    holes = np.round(rng.normal(size=31))
    holes[rng.random(31) < 0.5] = -np.inf
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    for exit_v in (rng.normal(size=31), np.zeros(31), holes, np.full(31, -np.inf)):
        exit_v = exit_v.astype(np_dt)
        j_e, j_s = (np.asarray(x) for x in _ENTRY(jnp.asarray(exit_v), j_hop))
        e, src = (x.numpy() for x in F.hop_entry(torch.as_tensor(exit_v), hop))
        np.testing.assert_array_equal(_bits(e), _bits(j_e))
        finite = np.isfinite(e)
        np.testing.assert_array_equal(src[finite], j_s[finite])
        e_p, src_p = (x.numpy() for x in F.hop_entry(torch.as_tensor(exit_v), padded))
        np.testing.assert_array_equal(_bits(e_p), _bits(j_e))
        np.testing.assert_array_equal(src_p, j_s)
    assert src.dtype == np.int32


def test_csr_build_matches_padded_rows():
    """``backoff_hop`` keeps exactly the finite slots of each padded row,
    sources ascending, each arc's destination its row; an edge-free
    graph's CSR is empty; the graph builds it from its own factors."""
    _, _, padded, hop = _case(40, 2, 8, 2, True, False, torch.float64, seed=11)
    ptr, src, val, dst = (x.numpy() for x in (hop.arc_ptr, hop.arc_src, hop.arc_val,
                                              hop.arc_dst))
    assert ptr[0] == 0 and ptr[-1] == len(src) == len(val) == len(dst)
    assert (np.diff(ptr) >= 0).all() and np.isfinite(val).all()
    assert hop.arc_ptr.dtype == hop.arc_src.dtype == hop.arc_dst.dtype == torch.int32
    pred, pval = padded.pred.numpy(), padded.val.numpy()
    for w in range(40):
        keep = np.isfinite(pval[w])
        order = np.argsort(pred[w][keep], kind="stable")
        np.testing.assert_array_equal(src[ptr[w]:ptr[w + 1]], pred[w][keep][order])
        np.testing.assert_array_equal(val[ptr[w]:ptr[w + 1]], pval[w][keep][order])
        assert (dst[ptr[w]:ptr[w + 1]] == w).all()
        assert (np.diff(src[ptr[w]:ptr[w + 1]]) > 0).all()
    assert (hop.from_w is padded.from_w and hop.uni is padded.uni
            and hop.sil_idx == padded.sil_idx)
    empty = F.backoff_hop(padded._replace(val=torch.full_like(padded.val, -np.inf)))
    assert len(empty.arc_src) == 0 and (empty.arc_ptr == 0).all()


HOP_PARAMS = ["hop_kind", "hop_t", "from_w", "uni", "sil_from", "sil_idx", "arc_ptr", "arc_dst",
              "arc_src", "arc_val"]
LAYOUT_PARAMS = ["blk_ptr", "src_ptr", "src", "arc_lsrc", "n_blocks", "max_words", "max_src"]


@pytest.mark.parametrize("name,argtypes", [("factored_forward", F._FWD_ARGTYPES),
                                           ("factored_backtrace", F._BWD_ARGTYPES),
                                           ("factored_lattice", F._LAT_ARGTYPES)])
def test_c_signatures_match_argtypes(name, argtypes):
    """Each kernel's C entry takes what its wrapper passes: the argument
    count, pointer or int at every place, the ten hop operands in
    ``_hop_args``'s order right after ``exit_idx``, for D and F the seven
    layout operands of ``_layout_args`` right after ``n_sm``, the hop
    kind ids and, for D and F, the exchange's sizes."""
    import ctypes
    import os
    import re

    csrc = os.path.join(os.path.dirname(F.__file__), "..", "csrc")
    src = open(os.path.join(csrc, f"{name}.cu")).read()
    sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*{{', src, re.S).group(1)
    # with the local headers it includes (D's and F's shared exchange)
    for header in re.findall(r'#include "(\w+\.cuh)"', src):
        src += open(os.path.join(csrc, header)).read()
    params = [p.strip() for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kinds == argtypes
    names = [re.split(r"[\s*]+", p)[-1] for p in params]
    assert names[3:13] == HOP_PARAMS
    if name != "factored_backtrace":  # the word-to-block layout, after n_sm
        at = names.index("n_sm") + 1
        assert names[at:at + 7] == LAYOUT_PARAMS and argtypes[at:at + 7] == F._MAP_ARGTYPES
    assert F._HOP_IDS == {"none": 0, "dense": 1, "rank1": 2, "backoff": 3}
    for kind, k in F._HOP_IDS.items():  # every kind id the source names is the wrapper's
        if f"HOP_{kind.upper()}" in src:
            assert f"constexpr int HOP_{kind.upper()} = {k};" in src
    if name != "factored_backtrace":  # the exchange's sizes, as the capacity rule mirrors them
        for const, value in (("PART", F.PART_WORDS), ("MAX_BLOCKS", F.MAX_BLOCKS),
                             ("MAX_THREADS", F.MAX_THREADS), ("SMEM_LIMIT", F.SMEM_LIMIT)):
            assert re.search(rf"constexpr int {const} = {value};", src)
