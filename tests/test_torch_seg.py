"""The port's HMM word segmenter against the JAX package's on the corpus of
``tests/test_seg.py``: labels, count tensors, state strings and words
must be equal (float64 count estimates decoded by the same max-plus scan,
so no tolerance), and HDF5 model files cross-load between packages.
"""

import numpy as np
import pytest
import torch

from lnasr_tpu.models.seg import Seg as JSeg
from lnasr_tpu.models.seg import SegDataSet as JSegDataSet
from lnasr_tpu.models.seg import render_segmentation as jrender
from lnasr_tpu_torch.models.seg import Seg, SegDataSet, render_segmentation
from tests.test_seg import CORPUS

SENTENCES = [
    "我们喜欢学习中文",
    "他们使用语言模型",
    "语言模型帮助分词",
    "我在图书馆学习隐马尔可夫模型。",
    "żółw隐马尔可夫",  # characters never seen in training
    "学",
]


@pytest.fixture(scope="module")
def trained():
    return (Seg(device="cpu").train(SegDataSet.mark(line) for line in CORPUS),
            JSeg().train(JSegDataSet.mark(line) for line in CORPUS))


def test_mark_matches_jax():
    for line in CORPUS[:12] + ["我 爱 你。", "图书馆", "（我们） 学习，", " a  bc "]:
        assert SegDataSet.mark(line) == JSegDataSet.mark(line)


def test_count_model_matches_jax(trained):
    port, ref = trained
    assert port.model.dtype == torch.float64 and (port.model.n, port.model.m) == (4, 65536)
    for g, r in zip(port.model.params, ref.model.params):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_segmentation_matches_jax(trained):
    port, ref = trained
    for text in SENTENCES:
        assert port.segment_states(text) == ref.segment_states(text)
        assert port.segment(text) == ref.segment(text)
    assert port.segment("我们喜欢学习中文") == ["我们", "喜欢", "学习", "中文"]
    assert port.segment_states("") == "" and port.segment("") == []


def test_save_load_across_packages(tmp_path, trained):
    port, ref = trained
    port.save(str(tmp_path / "port.h5"))
    ref.save(str(tmp_path / "jax.h5"))
    from_jax = Seg(device="cpu").load(str(tmp_path / "jax.h5"))
    from_port = JSeg().load(str(tmp_path / "port.h5"))
    for text in SENTENCES[2:4]:
        assert from_jax.segment(text) == port.segment(text) == from_port.segment(text)
        assert from_jax.segment_states(text) == from_port.segment_states(text)


def test_render_segmentation_matches_jax(trained):
    port, _ = trained
    pairs = [(text, port.segment_states(text)) for text in SENTENCES[:5]]
    for text, states in pairs + [("abc", "BME"), ("ｱｲ", "BE"), ("a\x0eb", "SSS")]:
        assert render_segmentation(text, states) == jrender(text, states)
    assert render_segmentation("我们学习", "BEBE") == ("我们 学习 ", "B E  B E  ")
