"""The port's dense-graph Viterbi (the CPU path of kernel C,
``ops/viterbi_dense.py``) against the JAX package on identical float32
inputs: the scan with masks and termination weights, and the TPU kernel
``viterbi_pallas_dense`` in interpret mode.

Max-plus with the same two fp32 adds in the same order is exact, so paths
and scores must be bitwise equal to the JAX scan, ties and -inf
transitions included. The TPU kernel maps -inf to a finite -1e30, so
where the graph holds -inf it is compared on the path only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.ops.trellis import viterbi_scan as j_viterbi_scan
from lnasr_tpu.ops.trellis_pallas import viterbi_pallas_dense
from lnasr_tpu_torch.models.decoder import dense_viterbi
from lnasr_tpu_torch.ops.viterbi import viterbi_batched
from lnasr_tpu_torch.ops.viterbi_dense import (
    a_in_smem,
    smem_bytes,
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
    """Shared memory bounds the kernel, not the TPU's VMEM: log_a is staged
    up to ~230 states and read through L2 above; ``v`` and the staged
    backtrace frames fit a block up to ~3,200 states."""
    assert a_in_smem(179) and not a_in_smem(256)
    assert smem_bytes(256, False) < smem_bytes(179, True)
    assert viterbi_dense_ok(510, 179) and viterbi_dense_ok(510, 256)
    assert viterbi_dense_ok(4000, 2048)
    assert not viterbi_dense_ok(100, 4000)  # v + staged frames past 227 KB
    assert not viterbi_dense_ok(200_000, 2048, batch=4)  # backpointer scratch past 2 GiB
