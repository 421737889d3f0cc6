"""Runnable examples of the port, each ``python -m lnasr_tpu_torch.examples.<name>``
(on the card by default; ``--device cpu`` for the plain PyTorch paths):

- :mod:`.isolated_word_demo`: synthetic tone-burst words -> isolated-unit
  training -> bigram LM -> VAD-segmented connected decode -> WER;
- :mod:`.segmenter_demo`: supervised count training of the HMM word
  segmenter and Viterbi segmentation;
- :mod:`.multihost_train`: data-parallel Baum-Welch over
  ``torch.distributed`` ranks, one process per rank;
- :mod:`.real_audio_demo`: protocol v2 on speech recordings given as
  ``--fixtures``: VAD-cut vocabulary, multi-condition unit training
  through the CLI, connected-word decodes under six noise conditions ->
  WER per condition.
"""
