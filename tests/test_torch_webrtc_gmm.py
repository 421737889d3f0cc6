"""Kernel I (the WebRTC-style VAD's GMM recursion) on the CPU: its plain
version against the JAX package, a model of the kernel, the aging walk,
and the wrapper's dispatch.

- ``vad.webrtc.gmm_flags_plain`` (the frame loop the kernel is held to on
  the card) against ``jax.lax.scan(lnasr_tpu.vad.webrtc.gmm_step, ...)``
  on the same features (the port's filterbank of the ``vad_audio``
  fixture), modes 0-3: flags equal frame for frame; the final state's
  counters, tracker values and ages equal, its means, deviations and
  smoothed minima within ``rtol=1e-4``: the two packages' float32
  ``exp``/``log2`` differ in the last bits and the adaptation carries
  that through 1,250 frames (7.4e-6 relative at most, measured).
- ``vad.webrtc._age_walk`` (the torch mirror of the sequential aging walk
  that kernel I runs) and the plain version's compaction ``_age``, both
  bitwise against the JAX package's walk, ages past 100 included, on
  random states with runs of expiring slots (slot 15 evicted or passed
  over among them).
- A model of ``csrc/webrtc_gmm.cu``'s warps: the tracker lanes' ballot
  compaction of the aging walk (held bitwise to ``_age_walk``) and sorted
  insertion, producing every frame's smoothed minimum into a ring of
  stages guarded by a full and an empty barrier a stage; the GMM lanes
  (channel, model, Gaussian) consuming it, computing both outcomes of the
  flag and selecting one, the 6-channel sum in order 0..5; at float32
  and float64, held bit for bit to the plain version (flags and the whole
  final state: ``exp`` and ``log2`` are torch's on the plain version's
  shapes). The ring's order at a tiny stage, with a broken ring (trackers
  that never wait for the empty barrier) caught; runs of frames without
  power; tracker evictions. (The kernel's float divisions take
  ``__fdiv_rn``'s fast path by a refined reciprocal where their operands
  allow, the correctly rounded quotient either way: the model divides.)
- The wrapper: CPU tensors take the plain version and count no launch; a
  CUDA tensor goes to the kernel or raises (a stand-in: this machine has
  no card), never to the frame loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.vad import webrtc as jweb
from lnasr_tpu_torch.vad import webrtc as tweb


@pytest.fixture(autouse=True)
def _one_thread():
    """The frame loop is thousands of tiny tensor ops: one CPU thread runs
    them faster than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def features(vad_audio):
    """The port's filterbank features of the fixture, float32 and float64."""
    data = np.asarray(vad_audio)
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(data[: len(data) // 160 * 160]).to(dtype)
        feats, total, _ = tweb.extract_features(x, tweb.initial_filter_state(dtype))
        out[dtype] = (feats, total)
    return out


@pytest.fixture(scope="module")
def jax_gmm():
    """The JAX package's GMM scan, one compiled program for every mode
    (the thresholds are arguments): ``(final state, flags)``."""

    @jax.jit
    def run(feats, total, thresholds):
        step = functools.partial(jweb.gmm_step, thresholds=thresholds)
        return jax.lax.scan(step, jweb.initial_gmm_state(jnp.float32), (feats, total))

    def call(feats, total, mode):
        oh1, oh2, local, glob = jweb.MODE_TABLE[mode]
        thr = (jnp.asarray(oh1, jnp.int32), jnp.asarray(oh2, jnp.int32),
               jnp.asarray(local, jnp.float32), jnp.asarray(glob, jnp.float32))
        state, flags = run(jnp.asarray(feats.numpy()), jnp.asarray(total.numpy()), thr)
        return state, np.asarray(flags)
    return call


def _same_state(got, ref, what):
    """The final GMM state ``got`` (torch) against ``ref`` (arrays): see
    the module's docstring for the bars."""
    for name in tweb.GmmState._fields:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        if name in ("low_values", "value_ages", "frame_count", "over_hang", "speech_run"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_matches_jax_scan(features, jax_gmm, mode):
    feats, total = features[torch.float32]
    jstate, jflags = jax_gmm(feats, total, mode)
    flags, state = tweb.gmm_flags_plain(feats, total, tweb.MODE_TABLE[mode], final_state=True)
    assert flags.dtype == torch.int32 and flags.shape == (feats.shape[0],)
    np.testing.assert_array_equal(flags.numpy(), jflags)
    _same_state(state, jstate, f"mode {mode}")
    if mode < 2:  # the fixture has speech and hangover frames at these modes
        assert (jflags == 1).any() and (jflags >= 2).any()


def _random_tracker(rng):
    """Random tracker slots: sorted values, ages with runs of 100 at the
    start, the middle and the end (slot 15 passed over in channel 1,
    evicted in channels 3 and 4), and slots past 100."""
    ages = rng.integers(0, 99, size=(6, 16)).astype(np.int32)
    for ch in range(6):
        start = rng.integers(0, 16)
        ages[ch, start: start + rng.integers(1, 6)] = 100
        ages[ch, rng.integers(0, 16)] = 100
    ages[0, :] = 100
    ages[1, 12:] = 100
    ages[2, :] = rng.integers(99, 103, size=16)
    ages[3, 14:] = (50, 100)
    ages[4, 13:] = 100
    lows = np.sort(rng.uniform(0, 100, size=(6, 16)), axis=1).astype(np.float32)
    return lows, ages


def test_age_walk_matches_jax_walk_and_compaction():
    """The mirror of kernel I's walk and the plain version's compaction,
    both bitwise against the JAX package's fori_loop walk (its
    ``_find_minimum`` with a value above every slot inserts nothing), the
    empty slots' ages (101, or 102 where the walk reaches them) too."""
    rng = np.random.default_rng(14)
    find_minimum = jax.jit(jweb._find_minimum)
    consts = tweb._constants(torch.float32, "cpu")
    above = jnp.full((6,), 1e9, jnp.float32)
    for trial in range(60):
        lows, ages = _random_tracker(rng)
        wl, wa = (x.numpy() for x in tweb._age_walk(torch.as_tensor(lows), torch.as_tensor(ages)))
        state = jweb.initial_gmm_state()._replace(low_values=jnp.asarray(lows),
                                                  value_ages=jnp.asarray(ages))
        jl, ja, _ = (np.asarray(x) for x in find_minimum(state, above))
        np.testing.assert_array_equal(wl, jl, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(wa, ja, err_msg=f"trial {trial}")
        cl, ca = (x.numpy() for x in tweb._age(torch.as_tensor(lows), torch.as_tensor(ages),
                                               consts))
        np.testing.assert_array_equal(cl, jl, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(ca, ja, err_msg=f"trial {trial}")


# -- a model of kernel I ------------------------------------------------------------
#
# What ``csrc/webrtc_gmm.cu`` computes, laid out as there: the tracker warps
# (lane = channel, slot) produce every frame's smoothed minimum into a ring
# of stages guarded by a full and an empty barrier a stage; the GMM warp
# (lane = channel, model, Gaussian) consumes it, computes the frame's new
# state under both outcomes of the flag and selects one. Arithmetic in the
# working dtype, each operation rounded as there; ``exp`` and ``log2`` are
# torch's on tensors of the plain version's shapes, so that the model is
# held to the plain version bit for bit on the CPU.

STAGE, N_STAGES = 128, 3  # the kernel's ring


class RingOverwrite(AssertionError):
    """The trackers wrote a stage into a slot the GMM warp had not finished."""


class RingDeadlock(AssertionError):
    """Neither side of the ring can move."""


class _Barrier:
    """An mbarrier: ``count`` arrivals complete a phase; a wait on a parity
    passes once the phase of that parity has completed."""

    def __init__(self, count):
        self.count, self.arrived, self.phase = count, 0, 0

    def arrive(self, n):
        self.arrived += n
        if self.arrived == self.count:
            self.arrived, self.phase = 0, self.phase + 1

    def done(self, parity):
        return (self.phase & 1) != parity


def _bits(mask):
    return np.array([(int(mask) >> k) & 1 for k in range(16)], bool)


def _ballot(pred):
    return int(sum(1 << k for k in range(16) if pred[k]))


def _lane_age(low, age):
    """One channel's aging walk as the tracker lanes compute it (``low``,
    ``age`` of 16 slots): a ballot of the slots aged 100; each slot's run
    start by the highest unexpired slot below it (``32 - clz``); every
    other slot of a run evicted from its first; the kept slots moved left
    by the count of evicted slots below them, a slot right after an
    evicted one not aged; empty slots at the end, 102 old, but 101 for the
    first when slot 15 was evicted. Returns ``(low, age, evictions)``."""
    expd = _ballot(age == 100)
    if not expd:
        return low.copy(), age + 1, 0
    k = np.arange(16)
    below = (1 << k) - 1
    run = np.array([(~expd & int(b) & 0xFFFFFFFF).bit_length() for b in below])
    ev = _bits(expd) & ((k - run) % 2 == 0)
    evd = _ballot(ev)
    first_empty = 16 - int(ev.sum())
    passed = np.concatenate([[False], _bits(evd)[:-1]])
    nl, na = np.empty_like(low), np.empty_like(age)
    dst = k - np.array([bin(evd & int(b)).count("1") for b in below])
    nl[dst[~ev]], na[dst[~ev]] = low[~ev], np.where(passed, age, age + 1)[~ev]
    empty = k >= first_empty
    nl[empty] = 10000.0 / 16.0
    na[empty] = np.where((k == first_empty) & bool(evd >> 15), 101, 102)[empty]
    return nl, na, int(ev.sum())


def _trackers(feats, total, ring, full, empty, stage, n_stages, protocol, counts):
    """The tracker warps: stage by stage, wait for the slot to be empty (the
    kernel's parity: none in the first round), write the stage's features,
    activity and every frame's ``mv_new``, then arrive on its full
    barrier. Yields ``"wait"`` while blocked, ``"stage"`` after a stage.
    ``protocol="no_empty_wait"`` is a broken ring: it never waits."""
    dt = feats.dtype.type
    low, age = np.full((6, 16), dt(625.0)), np.zeros((6, 16), np.int32)
    mv, fc = np.full(6, dt(100.0)), 0
    for st, base in enumerate(range(0, len(feats), stage)):
        s, n = st % n_stages, min(stage, len(feats) - base)
        if st >= n_stages and protocol != "no_empty_wait":
            while not empty[s].done(((st // n_stages) & 1) ^ 1):
                yield "wait"
        ring["stage"][s] = st
        ring["x"][s, :n] = feats[base: base + n]
        ring["active"][s, :n] = total[base: base + n] > dt(10)
        for i in range(n):
            x, nl, na = feats[base + i], np.empty_like(low), np.empty_like(age)
            for c in range(6):
                nl[c], na[c], ev = _lane_age(low[c], age[c])
                counts["evictions"] += ev
                below = np.nonzero(x[c] < nl[c])[0]  # the ballot's first slot
                if len(below):
                    p = below[0]
                    nl[c, p + 1:], na[c, p + 1:] = nl[c, p:-1].copy(), na[c, p:-1].copy()
                    nl[c, p], na[c, p] = x[c], 1
            median = nl[:, 2] if fc > 2 else (nl[:, 0] if fc > 0 else np.full(6, dt(100)))
            alpha = (np.where(median < mv, dt(6553 / 32768), dt(32439 / 32768)) if fc > 0
                     else np.full(6, dt(0)))
            mv_new = ((alpha + dt(1 / 32768)) * mv + (dt(1) - alpha) * median) + dt(1 / 32)
            ring["mv"][s, i] = mv_new
            if ring["active"][s, i]:
                low, age, mv, fc = nl, na, mv_new, fc + 1
        full[s].arrive(96)
        yield "stage"
    counts["tracker"] = (low, age, mv, fc)


def _exp(a):
    """torch's ``exp`` on a tensor of the plain version's shape."""
    return torch.exp(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def _log2(a):
    return torch.log2(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def _chain(n_frames, thresholds, dt, ring, full, empty, stage, n_stages, flags, counts):
    """The GMM warp over the ring: lanes ``[m, g, c]`` (model 0 noise, 1
    speech). Yields ``"wait"`` while its stage is not full, ``"frame"``
    after each frame; checks before each frame that the slot still holds
    its stage."""
    oh1, oh2, local_thr, global_thr = thresholds
    tiny, m = dt(1e-38), np.arange(2).reshape(2, 1, 1)
    g, c = np.arange(2).reshape(1, 2, 1), np.arange(6).reshape(1, 1, 6)
    a = lambda x: np.asarray(x, dt)  # noqa: E731
    w = a(np.stack([tweb._NOISE_W, tweb._SPEECH_W]))
    mu = a(np.stack([tweb._NOISE_MEANS, tweb._SPEECH_MEANS]))
    sd = a(np.stack([tweb._NOISE_STDS, tweb._SPEECH_STDS]))
    weight, min_diff = a(tweb._SPECTRUM_WEIGHT), a(tweb._MIN_DIFF)
    cap = a(np.stack([np.broadcast_to(tweb._MAX_NOISE, (2, 6)),
                      np.broadcast_to(tweb._MAX_SPEECH, (2, 6))]))
    lo = np.broadcast_to(a(5 + g), (2, 2, 6))
    hi = np.where(m == 1, a(105), a(72 + g - c))
    gain = np.where(m == 1, dt(6554 / 32768), dt(655 / 32768))
    two_ss, sq = (dt(2) * sd) * sd, sd * sd
    ngm = (mu[0] * w[0]).sum(0)  # a sum of two: the pair's order does not matter
    oh = sr = 0
    for st, base in enumerate(range(0, n_frames, stage)):
        s, n = st % n_stages, min(stage, n_frames - base)
        while not full[s].done((st // n_stages) & 1):
            yield "wait"
        for i in range(n):
            if ring["stage"][s] != st:
                raise RingOverwrite(f"frame {base + i}: slot {s} holds stage "
                                    f"{ring['stage'][s]}, not {st}")
            vad = False
            if ring["active"][s, i]:
                x, mvn = ring["x"][s, i], ring["mv"][s, i]
                # the decision
                d = x - mu
                qd = (d * d) / two_ss
                pg = np.stack([_exp(-np.minimum(qd[k], dt(80))) for k in range(2)]) / sd
                pw = w * np.where(qd < dt(22005 / 1024), pg, dt(0))
                h = pw[:, :1] + pw[:, 1:]  # (2, 1, 6): h0, h1
                shift = np.stack([np.where(h[k] <= 0, dt(31), dt(4) - _log2(np.maximum(h[k, 0],
                                                                                      tiny)))
                                  for k in range(2)])
                llr = shift[0, 0] - shift[1, 0]
                term = llr * weight
                sum_llr = term[0]
                for j in range(1, 6):
                    sum_llr = sum_llr + term[j]
                vad = bool((llr * dt(4) > dt(local_thr)).any()) or bool(sum_llr >= dt(global_thr))
                # the adaptation, both outcomes
                r0 = np.where(h > 0, pw[:, :1] / np.maximum(h, tiny), (1 - m).astype(dt))
                post = np.where(g == 0, r0, np.where((m == 0) | (h > 0), dt(1) - r0, dt(0)))
                delta = d / sq
                mu_u = mu + (gain * post) * delta
                eta = dt(154 / 256) * (mvn - ngm)
                mean_upd = np.minimum(np.maximum(np.where(m == 1, mu_u, mu_u + eta), lo), hi)
                mean_fix = np.where(m == 1, mu, np.minimum(np.maximum((mu + dt(0)) + eta, lo), hi))
                dev = post * (delta * d - dt(1))
                sd_upd = np.maximum(sd + np.where(m == 1, dev * dt(0.1), dev) / sd, dt(3))
                mo = [np.where(m == 1, mean_fix, mean_upd), np.where(m == 1, mean_upd, mean_fix)]
                for o in range(2):
                    gm = (mo[o] * w).sum(1, keepdims=True)  # (2, 1, 6): ngm2, sgm
                    t_sep = np.maximum(min_diff - (gm[1] - gm[0]), dt(0))
                    mo[o] = np.where(m == 1, mo[o] + dt(0.8) * t_sep, mo[o] - dt(0.2) * t_sep)
                    gm2 = (mo[o] * w).sum(1, keepdims=True)
                    mo[o] = mo[o] - np.maximum(gm2 - cap, dt(0))
                # the outcome
                adapts = (m == 1) == vad
                mu = mo[1] if vad else mo[0]
                two_ss = np.where(adapts, (dt(2) * sd_upd) * sd_upd, two_ss)
                sq = np.where(adapts, sd_upd * sd_upd, sq)
                sd = np.where(adapts, sd_upd, sd)
                ngm = (mu[0] * w[0]).sum(0)
                counts["active"] += 1
            hang = not vad and oh > 0
            flags[base + i] = oh + 2 if hang else int(vad)
            oh = (oh2 if sr >= 6 else oh1) if vad else oh - int(hang)
            sr = min(sr + 1, 6) if vad else 0
            yield "frame"
        empty[s].arrive(32)
    counts["chain"] = (mu, sd, oh, sr)


def _kernel_model(feats, total, thresholds, stage=STAGE, n_stages=N_STAGES, protocol="ring",
                  schedule="greedy"):
    """Kernel I on ``feats (F, 6)``, ``total (F,)`` (NumPy, float32 or
    float64), the GMM warp a frame at a time, the trackers between its
    frames as far ahead as the ring lets them (``schedule="greedy"``) or a
    stage at a time (``"lockstep"``). Returns ``(flags, GmmState,
    counts)``; raises :class:`RingOverwrite` or :class:`RingDeadlock`."""
    dt = feats.dtype.type
    ring = {"x": np.zeros((n_stages, stage, 6), dt), "mv": np.zeros((n_stages, stage, 6), dt),
            "active": np.zeros((n_stages, stage), bool), "stage": [-1] * n_stages}
    full = [_Barrier(96) for _ in range(n_stages)]
    empty = [_Barrier(32) for _ in range(n_stages)]
    flags = np.zeros(len(feats), np.int32)
    counts = {"evictions": 0, "active": 0}
    sides = [_trackers(feats, total, ring, full, empty, stage, n_stages, protocol, counts),
             _chain(len(feats), thresholds, dt, ring, full, empty, stage, n_stages, flags,
                    counts)]
    live = [True, True]
    while any(live):
        moved = False
        for k, side in enumerate(sides):
            while live[k]:
                step = next(side, None)
                if step == "wait":
                    break
                moved = True
                if step is None:
                    live[k] = False
                elif k == 1 or schedule == "lockstep":
                    break
        if not moved:
            raise RingDeadlock("both sides wait")
    low, age, mv, fc = counts["tracker"]
    mu, sd, oh, sr = counts["chain"]
    t, i32 = torch.as_tensor, lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    state = tweb.GmmState(t(mu[0]), t(mu[1]), t(sd[0]), t(sd[1]), i32(fc), i32(oh), i32(sr),
                          t(low), t(age), t(mv))
    return flags, state, counts


def _same_bits(got, ref, what):
    """``got`` and ``ref`` (GmmState) equal bit for bit, dtypes too."""
    for name in tweb.GmmState._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, f"{what}: {name} dtype"
        if a.is_floating_point():
            a, b = a.view(torch.int32 if a.dtype == torch.float32 else torch.int64), \
                b.view(torch.int32 if b.dtype == torch.float32 else torch.int64)
        assert torch.equal(a, b), f"{what}: {name} differs"


def _held(feats, total, mode, **kw):
    """The model against ``gmm_flags_plain`` on the same inputs, flags and
    final state bit for bit; returns the model's counts."""
    thr = tweb.MODE_TABLE[mode]
    flags, state = tweb.gmm_flags_plain(feats, total, thr, final_state=True)
    mflags, mstate, counts = _kernel_model(feats.numpy(), total.numpy(), thr, **kw)
    np.testing.assert_array_equal(mflags, flags.numpy())
    _same_bits(mstate, state, f"mode {mode} {feats.dtype} F={len(feats)} {kw}")
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", [0, 2])
def test_kernel_model_matches_plain(features, mode, dtype):
    """The model on the fixture's 1,250 frames, bit for bit the plain loop's."""
    feats, total = features[dtype]
    counts = _held(feats, total, mode)
    assert counts["active"] > 0 and len(feats) > 2 * STAGE * N_STAGES  # the ring wraps


def test_lane_aging_matches_walk():
    """The tracker lanes' compaction, bitwise the sequential walk
    (``_age_walk``, itself held to the JAX walk) on random states with runs
    of expiring slots, slot 15 evicted or passed over among them."""
    rng = np.random.default_rng(16)
    for trial in range(60):
        lows, ages = _random_tracker(rng)
        wl, wa = (x.numpy() for x in tweb._age_walk(torch.as_tensor(lows), torch.as_tensor(ages)))
        for c in range(6):
            nl, na, _ = _lane_age(lows[c], ages[c])
            np.testing.assert_array_equal(nl, wl[c], err_msg=f"trial {trial} channel {c}")
            np.testing.assert_array_equal(na, wa[c], err_msg=f"trial {trial} channel {c}")


@pytest.mark.parametrize("n_frames", [0, 1, 3, 4, 5, 9])
def test_ring_order(features, n_frames):
    """A ring of two stages of four frames: the model equals the plain loop
    at every count of frames, the last stage full or not, whether the
    trackers run ahead or keep step. Trackers that do not wait for the
    empty barrier (three stages or more) overwrite a stage the GMM warp is
    still reading when they keep step, and when they run ahead, complete
    its full barrier twice, so that the GMM warp waits for ever."""
    feats, total = (x[200: 200 + n_frames] for x in features[torch.float32])
    thr = tweb.MODE_TABLE[1]
    for schedule in ("greedy", "lockstep"):
        _held(feats, total, 1, stage=4, n_stages=2, schedule=schedule)
    broken = functools.partial(_kernel_model, feats.numpy(), total.numpy(), thr, stage=4,
                               n_stages=2, protocol="no_empty_wait")
    if n_frames > 8:
        with pytest.raises(RingOverwrite):
            broken(schedule="lockstep")
        with pytest.raises(RingDeadlock):
            broken(schedule="greedy")
    else:
        for schedule in ("greedy", "lockstep"):
            broken(schedule=schedule)


@pytest.mark.parametrize("mode", [0, 3])
def test_kernel_model_inactive_runs(features, mode):
    """Runs of frames with too little power (total 0: no adaptation, the
    tracker not committed, only the hangover moves), across the ring's
    stage boundaries."""
    feats, total = (x[:700].clone() for x in features[torch.float32])
    for start, stop in ((0, 3), (120, 140), (250, 262), (383, 384), (500, 650)):
        total[start:stop] = 0.0
    counts = _held(feats, total, mode)
    assert counts["active"] == int((total > 10).sum()) == 700 - 186


def test_kernel_model_evictions(features):
    """A stream long enough for the tracker's slots to reach age 100 and
    be evicted: the fixture's features, then the same falling by 3 dB, so
    that old minima stay the lowest until they expire."""
    feats, total = features[torch.float32]
    feats = torch.cat([feats[:900], feats[:900] - 3.0])
    total = torch.cat([total[:900], total[:900]])
    counts = _held(feats, total, 0)
    assert counts["evictions"] > 0


# -- the wrapper ------------------------------------------------------------------


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrapper reads before
    it reaches the card."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, torch.Size(shape)

    def dim(self):
        return len(self.shape)


def test_wrapper_dispatch(features, monkeypatch):
    """CPU tensors take the plain version (``webrtc_vad_flags`` too) and
    count no launch; a CUDA tensor reaches the kernel (here: fails for want
    of a card) or raises on what the kernel does not take, never looping."""
    feats, total = features[torch.float32]
    feats, total = feats[:200], total[:200]
    tweb.gmm_flags.launches = 0
    thr = tweb.MODE_TABLE[1]
    assert torch.equal(tweb.gmm_flags(feats, total, thr), tweb.gmm_flags_plain(feats, total, thr))
    assert tweb.gmm_flags(feats[:0], total[:0], thr).shape == (0,)
    tweb.webrtc_vad_flags(torch.zeros(1600, dtype=torch.int16), mode=1)
    assert tweb.gmm_flags.launches == 0

    def no_loop(*a, **k):
        raise AssertionError("the frame loop ran for a CUDA tensor")
    monkeypatch.setattr(tweb, "gmm_flags_plain", no_loop)
    monkeypatch.setattr(tweb, "gmm_step", no_loop)
    with pytest.raises(ValueError, match="features \\(F, 6\\)"):
        tweb.gmm_flags(_CudaStandIn((50, 5)), _CudaStandIn((50,)), thr)
    with pytest.raises(ValueError, match="float32 or float64"):
        tweb.gmm_flags(_CudaStandIn((50, 6), torch.float16), _CudaStandIn((50,), torch.float16),
                       thr)
    with pytest.raises(ValueError, match="one dtype"):
        tweb.gmm_flags(_CudaStandIn((50, 6)), _CudaStandIn((50,), torch.float64), thr)
    with pytest.raises((RuntimeError, AssertionError)):  # the launch needs a card
        tweb.gmm_flags(_CudaStandIn((50, 6)), _CudaStandIn((50,)), thr)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tweb.gmm_flags(torch.zeros((5, 6), device="meta"), torch.zeros(5, device="meta"), thr)
    assert tweb.gmm_flags.launches == 0
