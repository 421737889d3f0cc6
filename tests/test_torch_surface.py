"""The port's import surface against the JAX package's: every name a JAX
package lists in ``__all__`` is importable from the port's counterpart,
the ``ops`` names are the port's own functions, and the versions agree."""

import importlib

import pytest

PACKAGES = ["", ".ops", ".models", ".utils", ".vad", ".parallel"]
OPS = ["logsumexp", "log_matvec", "log_matmul", "num_frames", "pad_length", "preemphasis",
       "split_frames", "hamming_window", "mel_from_hz", "hz_from_mel", "mel_filterbank",
       "power_spectrum", "dct2_ortho_matrix", "forward_scan", "backward_scan", "viterbi_scan",
       "forward_assoc", "posteriors"]


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "top")
def test_every_jax_export_is_importable_from_the_port(sub):
    jax_pkg = importlib.import_module("lnasr_tpu" + sub)
    port = importlib.import_module("lnasr_tpu_torch" + sub)
    missing = [n for n in jax_pkg.__all__ if not hasattr(port, n)]
    assert not missing, f"lnasr_tpu_torch{sub} lacks {missing}"
    assert set(jax_pkg.__all__) <= set(port.__all__)
    namespace = {}
    exec(f"from lnasr_tpu_torch{sub} import {', '.join(jax_pkg.__all__)}", namespace)


def test_ops_reexports_the_ports_own_functions_in_the_jax_order():
    import lnasr_tpu.ops as jops
    import lnasr_tpu_torch.ops as tops

    assert jops.__all__ == tops.__all__ == OPS
    for name in OPS:
        fn = getattr(tops, name)
        assert fn.__module__.startswith("lnasr_tpu_torch.ops."), (name, fn.__module__)
        assert fn is getattr(importlib.import_module(fn.__module__), name)
        assert fn is not getattr(jops, name)


def test_version_and_mesh_config():
    import lnasr_tpu
    import lnasr_tpu_torch
    from lnasr_tpu_torch import MeshConfig, __version__
    from lnasr_tpu_torch.config import MeshConfig as ConfigMeshConfig

    assert __version__ == lnasr_tpu.__version__ == lnasr_tpu_torch.__version__ == "0.1.0"
    assert MeshConfig is ConfigMeshConfig
    assert {"MeshConfig", "__version__"} <= set(lnasr_tpu_torch.__all__)
