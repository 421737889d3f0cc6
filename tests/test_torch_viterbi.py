"""The port's Viterbi (plain scan and the batched kernel's CPU path)
against the JAX package on identical float32 emissions.

Max-plus with the same two fp32 adds in the same order is exact, so paths
and scores must be bitwise equal to the JAX scan, ties and -inf
transitions included. The JAX Pallas kernel pads states with -1e30, so
where ``log_a`` holds -inf it is compared on the path only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.models.hmm import HMM as JHMM
from lnasr_tpu.ops.trellis import viterbi_scan as j_viterbi_scan
from lnasr_tpu.ops.trellis_pallas import viterbi_pallas
from lnasr_tpu_torch.models.hmm import HMM as THMM
from lnasr_tpu_torch.ops.trellis import viterbi_scan
from lnasr_tpu_torch.ops.viterbi import viterbi_batched, viterbi_plain, viterbi_small


def _model(rng, n, kind="random"):
    if kind == "ties":  # every transition and start ties
        return np.zeros(n, np.float32), np.zeros((n, n), np.float32)
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    if kind == "left_to_right":  # upper-bidiagonal: -inf off the band
        with np.errstate(divide="ignore"):
            log_a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
        log_a[-1, -1] = 0.0
        log_pi = np.full(n, -np.inf)
        log_pi[0] = 0.0
    return log_pi.astype(np.float32), log_a.astype(np.float32)


def _emissions(rng, b, t, n, kind="random"):
    lb = rng.normal(size=(b, t, n)).astype(np.float32)
    if kind == "ties":  # quantized: many exact ties in max and argmax
        lb = np.round(lb * 2.0) / 2.0
    return lb


# one jitted batch scan per shape, shared by every test in this file
_J_SCAN = jax.jit(jax.vmap(j_viterbi_scan, in_axes=(None, None, 0, 0, None)))


def _jax_scan(log_pi, log_a, log_b, mask=None, log_final=None):
    mask = np.ones(log_b.shape[:2], bool) if mask is None else mask
    if log_final is None:
        log_final = np.zeros(log_b.shape[-1], np.float32)  # adds exact zeros
    return _J_SCAN(*(jnp.asarray(x) for x in (log_pi, log_a, log_b, mask, log_final)))


def _tt(*xs):
    return [torch.as_tensor(x) for x in xs]


CASES = [(2, 3, 20, "random"), (5, 4, 60, "random"), (5, 3, 40, "ties"),
         (6, 3, 40, "left_to_right"), (32, 2, 25, "random"), (1, 2, 7, "random")]


@pytest.mark.parametrize("n,b,t,kind", CASES)
def test_scan_bitwise_vs_jax_scan(n, b, t, kind):
    rng = np.random.default_rng(n * 100 + t)
    log_pi, log_a = _model(rng, n, kind)
    log_b = _emissions(rng, b, t, n, kind)
    ref = _jax_scan(log_pi, log_a, log_b)
    got = viterbi_scan(*_tt(log_pi, log_a, log_b))
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_array_equal(got.backptr.numpy(), np.asarray(ref.backptr))


@pytest.mark.parametrize("kind", ["random", "ties", "left_to_right"])
def test_scan_masked_with_final_weights(kind):
    rng = np.random.default_rng(11)
    n, b, t = 6, 3, 30
    log_pi, log_a = _model(rng, n, kind)
    log_b = _emissions(rng, b, t, n, kind)
    mask = np.arange(t)[None, :] < np.array([30, 17, 1])[:, None]
    log_final = np.where(rng.random(n) < 0.5, -np.inf, rng.normal(size=n)).astype(np.float32)
    log_final[-1] = 0.0
    ref = _jax_scan(log_pi, log_a, log_b, mask, log_final)
    got = viterbi_scan(*_tt(log_pi, log_a, log_b, mask, log_final))
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(got.backptr.numpy(), np.asarray(ref.backptr))
    # one utterance alone: the (T, N) form without a batch dimension
    one = viterbi_scan(*_tt(log_pi, log_a, log_b[1], mask[1], log_final))
    np.testing.assert_array_equal(one.path.numpy(), got.path[1].numpy())


@pytest.mark.parametrize("n,b,t,kind", CASES)
def test_batched_vs_pallas_kernel(n, b, t, kind):
    """``viterbi_batched`` (the small-N kernel's CPU path) against the TPU
    kernel in interpret mode and against the JAX scan."""
    rng = np.random.default_rng(n * 7 + b)
    log_pi, log_a = _model(rng, n, kind)
    log_b = _emissions(rng, b, t, n, kind)
    path, score = viterbi_batched(*_tt(log_pi, log_a, log_b))
    assert path.dtype == torch.int32 and path.shape == (b, t) and score.shape == (b,)
    ref = _jax_scan(log_pi, log_a, log_b)
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(score.numpy(), np.asarray(ref.score))
    k_path, k_score = viterbi_pallas(jnp.asarray(log_pi), jnp.asarray(log_a),
                                     jnp.asarray(log_b), interpret=True)
    np.testing.assert_array_equal(path.numpy(), np.asarray(k_path))
    if kind != "left_to_right":
        np.testing.assert_array_equal(score.numpy(), np.asarray(k_score))


def test_batched_dispatch_large_n_and_checks():
    rng = np.random.default_rng(5)
    log_pi, log_a = _model(rng, 40)
    log_b = _emissions(rng, 2, 12, 40)
    path, score = viterbi_batched(*_tt(log_pi, log_a, log_b))
    ref = _jax_scan(log_pi, log_a, log_b)
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref.path))
    with pytest.raises(ValueError):
        viterbi_small(*_tt(log_pi, log_a, log_b))  # N > 32
    with pytest.raises(ValueError):
        viterbi_small(*_tt(log_pi[:5], log_a[:5, :5], log_b[0, :, :5]))  # not (B, T, N)
    p1, s1 = viterbi_plain(*_tt(log_pi[:5], log_a[:5, :5], log_b[..., :5]))
    p2, s2 = viterbi_small(*_tt(log_pi[:5], log_a[:5, :5], log_b[..., :5]))
    assert torch.equal(p1, p2) and torch.equal(s1, s2)
    assert viterbi_small.launches == 0  # CPU tensors never launch the kernel


def test_discrete_hmm_decode_matches_jax():
    rng = np.random.default_rng(2)
    n, m, b, t = 4, 6, 3, 25
    log_pi, log_a = _model(rng, n)
    log_b = np.log(rng.dirichlet(np.ones(m), size=n)).astype(np.float32)
    obs = rng.integers(0, m, size=(b, t))
    mask = np.arange(t)[None, :] < np.array([25, 10, 3])[:, None]
    jm = JHMM(n, m, log_a, log_b, log_pi, dtype=jnp.float32)
    tm = THMM(n, m, log_a, log_b, log_pi, device="cpu")
    np.testing.assert_array_equal(tm.decode(obs[0]).numpy(), np.asarray(jm.decode(obs[0])))
    np.testing.assert_array_equal(tm.decode_batch(obs, mask).numpy(),
                                  np.asarray(jm.decode_batch(obs, mask)))
    assert tm.params.log_a.shape == (n, n) and tm.emissions(obs[0]).shape == (t, n)
