"""The port's whole serving step against the JAX flagship, and the port's
package rules (no JAX imports; CUDA by default, never a silent CPU run).

The JAX side is built as ``__graft_entry__.py:_flagship`` builds it: the
5x8x39 GMM-HMM initialized from seeded frames, the XLA frontend (the CPU
backend's "auto" choice), per-utterance emissions and ``viterbi_batched``
(the Pallas kernel in interpret mode). Its parameters are carried into
the port through ``convert.py``.
"""

import ast
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.config import MFCCConfig as JMFCCConfig
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.gmmhmm import _emissions as j_emissions
from lnasr_tpu.models.mfcc import mfcc_features as j_mfcc_features
from lnasr_tpu.ops.trellis_pallas import viterbi_batched as j_viterbi_batched
from lnasr_tpu_torch import entry
from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.convert import params_from_numpy
from lnasr_tpu_torch.models.gmmhmm import GMMHMM
from lnasr_tpu_torch.models.decoder import DecodingGraph, FactoredDecodingGraph
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.mfcc import MFCC
from lnasr_tpu_torch.models.recognizer import AcousticModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "lnasr_tpu_torch")


def _jax_flagship():
    cfg = JGMMHMMConfig(n_states=5, n_mix=8, dim=39)
    mfcc_cfg = JMFCCConfig(energy_floor=1e-10)
    model = JGMMHMM(cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    model.init_from_data(jnp.asarray(rng.normal(scale=10.0, size=(256, 39)), jnp.float32),
                         jax.random.PRNGKey(0))
    params = model.params

    def forward_step(signals):
        feats = jax.vmap(lambda s: j_mfcc_features(s, mfcc_cfg, dtype=jnp.float32).features)(signals)
        log_b = jax.vmap(lambda f: j_emissions(params, f, cfg.cov_type)[0])(feats)
        paths, scores = j_viterbi_batched(params.log_pi, params.log_a, log_b, interpret=True)
        return paths, scores, feats

    return forward_step, params


@pytest.fixture(scope="module")
def signals(speech_audio):
    rng = np.random.default_rng(1)
    base = np.asarray(speech_audio, np.float32)
    speech = np.stack([np.resize(base[i * 911:], 16000) for i in range(2)])
    noise = rng.normal(scale=3000.0, size=(1, 16000))
    return np.concatenate([speech, noise]).astype(np.float32)


def test_forward_step_matches_jax_flagship(signals):
    """Features within 0.01; scores within 1e-4 relative (the emissions
    differ by fp32 reassociation, ~1e-6 of |log_b|, summed over ~100
    frames); paths equal: a flipped frame would need two candidate
    paths within that score difference, and the test reports which frame
    and by how much if it ever happens."""
    j_step, j_params = _jax_flagship()
    j_paths, j_scores, j_feats = (np.asarray(x) for x in j_step(jnp.asarray(signals)))

    params = params_from_numpy(*j_params, device="cpu")
    step = entry.flagship(device="cpu", params=params)
    paths, scores = step(torch.as_tensor(signals))
    assert paths.shape == (3, 99) and paths.dtype == torch.int32 and scores.shape == (3,)
    assert torch.isfinite(scores).all()

    feats, _ = MFCC(entry.MFCC_CONFIG, device="cpu").features_fast(signals)
    assert np.max(np.abs(feats.numpy() - j_feats)) < 0.01
    np.testing.assert_allclose(scores.numpy(), j_scores, rtol=1e-4)
    diff = np.argwhere(paths.numpy() != j_paths)
    assert diff.size == 0, f"paths differ at (utterance, frame) {diff.tolist()[:10]}"


def test_flagship_model_and_entry_on_cpu():
    model = entry.flagship_model(device="cpu")
    assert model.mu.shape == (5, 8, 39) and model.cov.shape == (5, 8, 39)
    assert isinstance(model.config.var_floor, tuple)  # resolved from the data
    step, (example,) = entry.entry(device="cpu")
    assert example.shape == (4, 16000) and example.device.type == "cpu"
    paths, scores = step(example)
    assert paths.shape == (4, 99) and torch.isfinite(scores).all()
    again, _ = entry.flagship(device="cpu", params=model.params)(example)
    assert torch.equal(again, paths)


def _port_sources():
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "kernel_timing.py",
                                             "kernel_phases.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    files = _port_sources()
    assert len(files) > 10 and os.path.exists(files[0])
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "lnasr_tpu"), f"{path} imports {mod}"


PORT_MODULES = [
    "lnasr_tpu_torch.entry", "lnasr_tpu_torch.convert", "lnasr_tpu_torch._build",
    "lnasr_tpu_torch.models", "lnasr_tpu_torch.models.recognizer",
    "lnasr_tpu_torch.models.decoder", "lnasr_tpu_torch.models.ngram",
    "lnasr_tpu_torch.models.lexicon", "lnasr_tpu_torch.ops.factored",
    "lnasr_tpu_torch.ops.viterbi_dense", "lnasr_tpu_torch.utils.text",
    "lnasr_tpu_torch.cli", "lnasr_tpu_torch.utils.logging", "lnasr_tpu_torch.utils.profiling",
    "lnasr_tpu_torch.bench", "lnasr_tpu_torch.bench.headline", "lnasr_tpu_torch.bench.train",
    "lnasr_tpu_torch.bench.corpus", "lnasr_tpu_torch.bench.decoder",
    "lnasr_tpu_torch.bench.scaling", "lnasr_tpu_torch.examples",
    "lnasr_tpu_torch.examples.isolated_word_demo", "lnasr_tpu_torch.examples.segmenter_demo",
    "lnasr_tpu_torch.examples.multihost_train", "lnasr_tpu_torch.ops",
    "lnasr_tpu_torch.bench.stream", "lnasr_tpu_torch.bench.wer",
    "lnasr_tpu_torch.examples.real_audio_demo", "lnasr_tpu_torch.ops.trigram",
    "lnasr_tpu_torch.vad.webrtc",
]


def test_port_sources_cover_the_slice_modules():
    rel = {os.path.relpath(p, REPO) for p in _port_sources()}
    for mod in PORT_MODULES:
        path = mod.replace(".", "/")
        assert f"{path}.py" in rel or f"{path}/__init__.py" in rel, mod


def test_port_import_loads_no_jax():
    code = (f"import sys, {', '.join(PORT_MODULES)}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'lnasr_tpu')); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def _one_word():
    """A one-word lexicon over a duck-typed 2-state NumPy unit."""
    unit = types.SimpleNamespace(
        n=2, config=GMMHMMConfig(), log_a=np.log(np.full((2, 2), 0.5)),
        log_w=np.zeros((2, 1)), mu=np.zeros((2, 1, 39)), cov=np.ones((2, 1, 39)))
    return Lexicon.whole_word(["a"]), {"a": unit}


def test_one_word_graphs_build_on_cpu():
    lex, units = _one_word()
    assert DecodingGraph.build(lex, units, device="cpu").n_states == 2
    assert FactoredDecodingGraph.build(lex, units, device="cpu").grid_shape == (1, 2)


@pytest.mark.parametrize("make", [
    lambda: entry.flagship(),
    lambda: entry.entry(),
    lambda: entry.flagship_model(),
    lambda: MFCC(),
    lambda: GMMHMM(),
    lambda: entry.recognizer_serving(2),
    lambda: AcousticModel(),
    lambda: DecodingGraph.build(*_one_word()),
    lambda: FactoredDecodingGraph.build(*_one_word()),
])
def test_default_device_is_cuda_and_raises_without_it(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
