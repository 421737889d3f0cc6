"""The port's dense-graph Viterbi (the CPU path of kernel C,
``ops/viterbi_dense.py``) against the JAX package on identical float32
inputs: the scan with masks and termination weights, and the TPU kernel
``viterbi_pallas_dense`` in interpret mode.

Max-plus with the same two fp32 adds in the same order is exact, so paths
and scores must be bitwise equal to the JAX scan, ties and -inf
transitions included. The TPU kernel maps -inf to a finite -1e30, so
where the graph holds -inf it is compared on the path only.

The CUDA kernel cannot run here, so its reduction order does: a NumPy
model of its source lists, lane split and shuffle merge is held bitwise
against the same references. The wrappers' refusals on CUDA (float64,
past capacity) are shown with stand-ins that carry a CUDA device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.ops.trellis import viterbi_scan as j_viterbi_scan
from lnasr_tpu.ops.trellis_pallas import viterbi_pallas_dense
from lnasr_tpu_torch import entry
from lnasr_tpu_torch.models.decoder import dense_viterbi
from lnasr_tpu_torch.ops.viterbi import viterbi_batched
from lnasr_tpu_torch.ops.viterbi_dense import (
    KREG,
    a_in_smem,
    lists_fit,
    route,
    smem_bytes,
    threads_for,
    viterbi_dense,
    viterbi_dense_ok,
    viterbi_dense_plain,
)

_J_SCAN = jax.jit(j_viterbi_scan)


def _graph(rng, n, kind):
    if kind == "ties":  # every transition and start ties
        return np.zeros(n, np.float32), np.zeros((n, n), np.float32)
    if kind == "left_to_right":  # upper-bidiagonal: -inf off the band
        with np.errstate(divide="ignore"):
            log_a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
        log_a[-1, -1] = 0.0
        log_pi = np.full(n, -np.inf)
        log_pi[0] = 0.0
        return log_pi.astype(np.float32), log_a.astype(np.float32)
    return (np.log(rng.dirichlet(np.ones(n))).astype(np.float32),
            np.log(rng.dirichlet(np.ones(n), size=n)).astype(np.float32))


def _emissions(rng, t, n, kind):
    lb = rng.normal(scale=2.0, size=(t, n)).astype(np.float32)
    return np.round(lb) if kind == "ties" else lb


def _jax(log_pi, log_a, log_b, mask=None, log_final=None):
    t, n = log_b.shape
    mask = np.ones(t, bool) if mask is None else mask
    log_final = np.zeros(n, np.float32) if log_final is None else log_final  # adds exact zeros
    res = _J_SCAN(*(jnp.asarray(x) for x in (log_pi, log_a, log_b, mask, log_final)))
    return np.asarray(res.path), np.asarray(res.score)


def _tt(*xs):
    return [None if x is None else torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("kind", ["random", "ties", "left_to_right"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("final", [False, True])
def test_plain_bitwise_vs_jax_scan(kind, masked, final):
    rng = np.random.default_rng([len(kind), masked, final])
    n, t = 45, 37
    log_pi, log_a = _graph(rng, n, kind)
    log_b = _emissions(rng, t, n, kind)
    mask = None
    if masked:  # a padded tail and one interior gap
        mask = np.arange(t) < 29
        mask[11] = False
    log_final = None
    if final:
        log_final = np.where(rng.random(n) < 0.5, -np.inf, rng.normal(size=n)).astype(np.float32)
        log_final[-1] = 0.0
    path, score = viterbi_dense(*_tt(log_pi, log_a, log_b, mask, log_final))
    assert path.dtype == torch.int32 and path.shape == (t,) and score.shape == ()
    ref_path, ref_score = _jax(log_pi, log_a, log_b, mask, log_final)
    np.testing.assert_array_equal(path.numpy(), ref_path)
    np.testing.assert_array_equal(score.numpy(), ref_score)
    if masked:  # masked frames self-point: the path stands still there
        assert path[11] == path[10] and bool((path[28:] == path[28]).all())


@pytest.mark.parametrize("kind", ["random", "ties", "left_to_right"])
@pytest.mark.parametrize("final", [False, True])
def test_plain_vs_pallas_dense_interpret(kind, final):
    """Against the TPU kernel in interpret mode (no mask: it takes none)."""
    rng = np.random.default_rng(7 + final)
    n, t = 40, 23
    log_pi, log_a = _graph(rng, n, kind)
    log_b = _emissions(rng, t, n, kind)
    log_final = rng.normal(size=n).astype(np.float32) if final else None
    path, score = viterbi_dense_plain(*_tt(log_pi, log_a, log_b, None, log_final))
    k_path, k_score = viterbi_pallas_dense(
        jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b),
        None if log_final is None else jnp.asarray(log_final), interpret=True)
    np.testing.assert_array_equal(path.numpy(), np.asarray(k_path))
    if kind != "left_to_right":
        assert float(score) == float(k_score)


def test_batched_and_dense_dispatch():
    """A batch dimension and ``viterbi_batched`` above 32 states take the
    same function; ``dense_viterbi`` (the decoder's dispatch) returns the
    scan's results on the CPU."""
    rng = np.random.default_rng(3)
    n, b, t = 33, 3, 19
    log_pi, log_a = _graph(rng, n, "random")
    log_b = np.stack([_emissions(rng, t, n, "random") for _ in range(b)])
    mask = np.arange(t)[None, :] < np.array([19, 7, 1])[:, None]
    paths, scores = viterbi_dense(*_tt(log_pi, log_a, log_b, mask))
    assert paths.shape == (b, t) and scores.shape == (b,)
    for i in range(b):
        ref_path, ref_score = _jax(log_pi, log_a, log_b[i], mask[i])
        np.testing.assert_array_equal(paths[i].numpy(), ref_path)
        assert float(scores[i]) == float(ref_score)
    bp, bs = viterbi_batched(*_tt(log_pi, log_a, log_b))
    for i in range(b):
        ref_path, ref_score = _jax(log_pi, log_a, log_b[i])
        np.testing.assert_array_equal(bp[i].numpy(), ref_path)
        assert float(bs[i]) == float(ref_score)
    dp, ds = dense_viterbi(*_tt(log_pi, log_a, log_b[1], None, mask[1]))
    assert torch.equal(dp, paths[1]) and torch.equal(ds, scores[1])
    assert viterbi_dense.launches == 0  # CPU tensors never launch the kernel


def test_capacity_rule():
    """Shared memory bounds the kernel, not the TPU's VMEM: the source lists
    of a dense log_a fit up to ~180 states, log_a itself (for graphs whose
    lists do not fit) up to ~230, and above that it is read through L2;
    ``v`` and the staged backtrace frames fit a block up to ~3,200 states,
    the forward's regions sharing their space."""
    assert a_in_smem(179) and not a_in_smem(256)
    assert lists_fit(179, 179 * 179) and not lists_fit(256, 256 * 256)
    assert lists_fit(256, 867) and lists_fit(1000, 25_000)  # sparse graphs keep their lists
    assert smem_bytes(256) <= smem_bytes(3214) and smem_bytes(3214) + 1024 <= 232448
    assert viterbi_dense_ok(510, 179) and viterbi_dense_ok(510, 256)
    assert viterbi_dense_ok(4000, 2048)
    assert not viterbi_dense_ok(100, 4000)  # v + staged frames past 227 KB
    assert not viterbi_dense_ok(200_000, 2048, batch=4)  # backpointer scratch past 2 GiB
    # every N the first design took (72 N + 1024 bytes within 227 KB)
    assert all(viterbi_dense_ok(1, n) == (72 * n + 1024 <= 232448) for n in range(1, 3300))


def test_route_rule():
    """The route kernel C takes, from its list lengths alone: registers
    while every lane holds <= KREG entries in one round of the block; lists
    in shared memory for longer lists where ``log_a`` does not fit there
    or they hold under a third of it; whole columns otherwise, or where
    the lists do not fit."""
    v22 = _v22_graph()[1]
    lengths = (1 + np.isfinite(v22[1:]).sum(0)).tolist()
    assert route(lengths) == "registers" and sum(lengths) == 1044
    assert route([64] * 64) == "registers" and route([33] * 33) == "registers"
    assert route([179] * 179) == "columns" and route([25] * 179) == "registers"
    assert route([59] * 179) == "lists" and route([60] * 179) == "columns"  # a third of A
    assert route([128] * 256) == "lists"  # half of A, which is read through L2
    assert route([21] * 1000) == "lists" and route([1000] * 1000) == "columns"
    assert route([41] * 1000) == "columns"  # lists past the shared-memory pool
    assert route([9] * 2000) == "lists"  # lanes over two rounds of the block


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrapper reads before
    it refuses."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, tuple(shape)

    def dim(self):
        return len(self.shape)

    def __getitem__(self, idx):
        assert idx is None
        return _CudaStandIn((1,) + self.shape, self.dtype)

    def contiguous(self):
        return self


def test_dense_viterbi_raises_on_cuda_instead_of_the_scan():
    """``dense_viterbi`` always takes the wrapper: the scan on the CPU (as
    before, bitwise), kernel C on CUDA, which refuses float64 and shapes
    past its capacity instead of dropping to the scan; no launch is
    counted."""
    rng = np.random.default_rng(11)
    log_pi, log_a = _graph(rng, 40, "random")
    log_b = _emissions(rng, 17, 40, "random")
    path, score = dense_viterbi(*_tt(log_pi, log_a, log_b))
    ref_path, ref_score = _jax(log_pi, log_a, log_b)
    np.testing.assert_array_equal(path.numpy(), ref_path)
    assert float(score) == float(ref_score)
    pi, a = _CudaStandIn((40,)), _CudaStandIn((40, 40))
    with pytest.raises(ValueError, match="takes float32"):
        dense_viterbi(pi, a, _CudaStandIn((17, 40), torch.float64))
    big = 4000  # v + staged backtrace frames past a block's shared memory
    with pytest.raises(ValueError, match="past the dense kernel's capacity"):
        dense_viterbi(_CudaStandIn((big,)), _CudaStandIn((big, big)), _CudaStandIn((17, big)))
    with pytest.raises(ValueError, match="past the dense kernel's capacity"):
        viterbi_dense(pi, a, _CudaStandIn((8, 5_000_000, 40)))  # scratch past 2 GiB
    assert viterbi_dense.launches == 0


# -- a model of kernel C's reduction order -------------------------------------


def _ceil_pow2(x):
    return 1 << max(0, (x - 1).bit_length())


def _kernel_lanes(log_a, nth):
    """The lanes ``csrc/viterbi_dense.cu``'s prologue lays out: per target
    the source list (i = 0, then the ascending i >= 1 with a finite
    ``A[i, j]``), split over ``g`` lanes (a power of two <= 32) into
    contiguous sub-ranges of at most ``per`` entries, ``per`` doubled from
    KREG until the lanes fit the block; groups packed largest first (the
    kernel's order within a size is its atomics'; any order gives the same
    result). On the columns route (lists past shared memory, or too long
    for registers and over 2/3 of ``A``) every target's sources are all i,
    over ``cg`` lanes: the largest power of two <= 32 with ``cg * n``
    within the block. Returns ``(route, lanes)``."""
    n = log_a.shape[0]
    lists = [[0] + [i for i in range(1, n) if log_a[i, j] != -np.inf] for j in range(n)]
    way = route([len(lst) for lst in lists])
    if way == "columns":
        cg = 1
        while cg < 32 and 2 * cg * n <= nth:
            cg *= 2
        sub = -(-n // cg)
        lanes = [(j, cg, list(range(min(n, r * sub), min(n, r * sub + sub))), r == 0)
                 for j in range(n) for r in range(cg)]
        return way, lanes + [(-1, 1, [], False)] * (-len(lanes) % 32)
    per = KREG
    while True:
        g = [min(32, _ceil_pow2(-(-len(lst) // per))) for lst in lists]
        if sum(g) <= nth or per >= n:
            break
        per *= 2
    lanes = []  # (target, group size, sources, group's first lane)
    for j in sorted(range(n), key=lambda j: -g[j]):
        sub = -(-len(lists[j]) // g[j])
        for r in range(g[j]):
            a = min(len(lists[j]), r * sub)
            lanes.append((j, g[j], lists[j][a:a + sub], r == 0))
    lanes += [(-1, 1, [], False)] * (-len(lanes) % 32)  # idle lanes of the last warp
    assert (way == "registers") == (sum(g) <= nth and max(len(ln[2]) for ln in lanes) <= KREG)
    return way, lanes


def _merge(bv, bi, ov, oi):
    return (ov, oi) if ov > bv or (ov == bv and oi < bi) else (bv, bi)


def _kernel_model(log_pi, log_a, log_b, mask=None, log_final=None):
    """Kernel C in NumPy float32, step by step: each lane's strict-> chain
    over its sub-range (the group's first lane starting from its first
    entry, i = 0; the others from (-inf, none)), the xor-shuffle merge that
    keeps the lower index on equal values, the leader's emission add;
    masked frames as identity steps. Returns ``(path, score, route, lanes, cross_lane_ties)``: the
    number of (frame, target) steps whose maximum two lanes reached."""
    t_len, n = log_b.shape
    nth = threads_for(n)
    way, lanes = _kernel_lanes(log_a, nth)
    big = np.iinfo(np.int32).max
    v = (log_pi + log_b[0]).astype(np.float32)
    bp = np.zeros((t_len, n), np.int64)
    ties = 0
    for t in range(1, t_len):
        if mask is not None and not mask[t]:
            bp[t] = np.arange(n)
            continue
        new = np.empty(n, np.float32)
        res = []
        for j, g, srcs, lead in lanes:
            best, arg = np.float32(-np.inf), big
            for k, i in enumerate(srcs):
                c = v[i] + log_a[i, j]
                if k == 0 and lead:
                    best, arg = c, i
                elif c > best:
                    best, arg = c, i
            res.append((best, arg))
        for j in range(n):
            lane_best = [r for r, ln in zip(res, lanes) if ln[0] == j and r[1] != big]
            top = max(r[0] for r in lane_best)
            ties += sum(r[0] == top for r in lane_best) > 1
        for off in (16, 8, 4, 2, 1):
            before = list(res)
            for k, (_, g, _, _) in enumerate(lanes):
                if off < g:
                    res[k] = _merge(*before[k], *before[k ^ off])
        for (j, _, _, lead), (best, arg) in zip(lanes, res):
            if lead:
                new[j], bp[t, j] = best + log_b[t, j], arg
        v = new
    fin = v if log_final is None else v + log_final
    last = int(np.argmax(fin))
    path = [last]
    for t in range(t_len - 1, 0, -1):
        path.append(int(bp[t, path[-1]]))
    return np.asarray(path[::-1], np.int32), fin[last], way, lanes, ties


@functools.lru_cache(maxsize=None)
def _v22_graph():
    """The V = 22 recognizer's 179-state dense graph ``(log_pi, log_a,
    log_final)`` as NumPy."""
    g = entry.recognizer_serving(22, device="cpu")[0].graph
    return tuple(x.numpy() for x in (g.log_pi, g.log_a, g.log_final))


def _model_case(name):
    """``(log_pi, log_a, log_b, mask, log_final)`` of one model case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    t = 14
    mask = np.arange(t) < t - 3
    mask[5] = False
    if name == "v22":
        log_pi, log_a, log_final = _v22_graph()
        log_b = rng.normal(scale=3.0, size=(t, log_a.shape[0])).astype(np.float32)
        return log_pi, log_a, log_b, mask, log_final
    kind, n = name.split("-")
    n = int(n)
    ties = "ties" in kind
    log_pi, log_a = _graph(rng, n, "ties" if ties else "random")
    if kind.startswith("sparse"):  # 40 sources a target: 2 lanes of up to 21 entries
        keep = np.zeros((n, n), bool)
        for j in range(n):
            keep[rng.choice(n, size=40, replace=False), j] = True
        log_a = np.where(keep, log_a, -np.inf).astype(np.float32)
    log_b = _emissions(rng, t, n, "ties" if ties else "random")
    if kind == "column":  # a target no source reaches
        log_a[:, 7] = -np.inf
    log_final = rng.normal(size=n).astype(np.float32)
    return log_pi, log_a, log_b, mask if kind != "random" else None, log_final


# each case and the route the kernel takes on it: lists in registers, lists
# in shared memory, or whole columns split over lanes (dense graphs past
# registers)
MODEL_CASES = {"v22": "registers", "random-33": "registers", "random-64": "registers",
               "random-179": "columns", "column-64": "registers", "ties-64": "registers",
               "ties-179": "columns", "sparse-300": "lists", "sparseties-300": "lists"}


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_kernel_model_bitwise(name):
    """The model of the kernel's lists, lane split and merge against the
    plain scan (paths and scores) and the JAX package's TPU kernel in
    interpret mode (paths; scores where the graph holds no -inf, since the
    TPU kernel maps -inf to -1e30), on masked and unmasked frames, on each
    of the kernel's three routes."""
    log_pi, log_a, log_b, mask, log_final = _model_case(name)
    path, score, way, lanes, ties = _kernel_model(log_pi, log_a, log_b, mask, log_final)
    assert way == MODEL_CASES[name]
    n = log_a.shape[0]
    if name == "v22":  # the long word-entry lists split, the short ones stay whole
        sizes = {j: g for j, g, _, _ in lanes if j >= 0}
        assert max(sizes.values()) == 4 and sum(sizes.values()) <= threads_for(n)
        assert max(len(s) for _, _, s, _ in lanes) <= KREG
    if name == "random-179":  # columns over 4 lanes of 45 rows, 716 of the 1024 threads
        assert {g for _, g, _, _ in lanes} == {4, 1} and sum(j >= 0 for j, *_ in lanes) == 716
    if "ties" in name:
        assert ties > 0  # equal maxima in different lanes' sub-ranges
    p_path, p_score = viterbi_dense_plain(*_tt(log_pi, log_a, log_b, mask, log_final))
    np.testing.assert_array_equal(path, p_path.numpy())
    assert score.tobytes() == p_score.numpy().tobytes()
    if mask is not None:
        return  # the TPU kernel takes no mask
    k_path, k_score = viterbi_pallas_dense(*(jnp.asarray(x) for x in (log_pi, log_a, log_b,
                                                                       log_final)),
                                           interpret=True)
    np.testing.assert_array_equal(path, np.asarray(k_path))
    if np.isfinite(log_a).all():
        assert float(score) == float(k_score)


def test_kernel_model_unmasked_v22_vs_pallas():
    """The V = 22 graph without a mask, against the TPU kernel in interpret
    mode (paths; its -1e30 stands in for -inf, so scores differ)."""
    log_pi, log_a, log_b, _, log_final = _model_case("v22")
    path, score, _, _, _ = _kernel_model(log_pi, log_a, log_b, None, log_final)
    k_path, _ = viterbi_pallas_dense(*(jnp.asarray(x) for x in (log_pi, log_a, log_b, log_final)),
                                     interpret=True)
    np.testing.assert_array_equal(path, np.asarray(k_path))
    p_path, p_score = viterbi_dense_plain(*_tt(log_pi, log_a, log_b, None, log_final))
    np.testing.assert_array_equal(path, p_path.numpy())
    assert score.tobytes() == p_score.numpy().tobytes()
