"""Chinese word segmentation demo: supervised count training + Viterbi.

    python -m lnasr_tpu_torch.examples.segmenter_demo [path/to/icwb2-style-corpus.txt] \\
        [--device cpu]

With no corpus, trains on a tiny built-in corpus. The port of the JAX
package's ``examples/segmenter_demo.py``.
"""

from __future__ import annotations

import argparse
import sys

from lnasr_tpu_torch.models.seg import Seg, SegDataSet, render_segmentation

BUILTIN = [
    "我们 喜欢 学习 语言 模型",
    "他 在 图书馆 学习",
    "隐马尔可夫 模型 很 有用",
    "我们 使用 中文 分词",
    "语言 模型 帮助 中文 分词",
    "他 喜欢 中文",
    "我 用 隐马尔可夫 模型 分词",
] * 5

TEXTS = ["我们喜欢用隐马尔可夫模型分词", "他在图书馆学习语言模型"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("corpus", nargs="?", default=None, help="icwb2-style corpus file")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.corpus:
        samples = SegDataSet(args.corpus)
        print(f"training on {args.corpus}")
    else:
        samples = (SegDataSet.mark(line) for line in BUILTIN)
        print("training on the built-in mini corpus")
    seg = Seg(device=args.device).train(samples)

    for text in TEXTS:
        states = seg.segment_states(text)
        rendered, state_line = render_segmentation(text, states)
        print()
        print(rendered)
        print(state_line)
        print(" / ".join(seg.segment(text)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
