"""Data-parallel batched decoding over a rank mesh.

Serving scale-out for the composed word-graph search: a batch of
(bucket-padded) feature segments shards across the mesh's ``data`` axis,
each rank decodes its rows with the graph's own batched decode
(``decode_batch_arrays``: on CUDA, for the factored graph, the forward and
replay-backtrace kernels once each for the rank's rows, for every hop
kind; for the trigram graph kernel H's forward and backtrace once each for
the rank's rows; as the JAX package's vmapped scan is one program a chip),
and the paths and scores are
gathered exactly (int32 paths and float scores as bit patterns), so every
rank holds the whole batch's
results. The graph is replicated: every rank builds the same one from
the same seed. Equal, bitwise, to the single-process ``decode_batch``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from lnasr_tpu_torch.models.decoder import _batch_results
from lnasr_tpu_torch.parallel.distributed import all_gather
from lnasr_tpu_torch.parallel.mesh import local_rows, mesh_axis


def make_dp_decode_step(mesh, graph):
    """A sharded decode ``(obs (b, T, D), masks (b, T)) -> (paths (B, T)
    int32, scores (B,))``: ``obs``/``masks`` are this rank's rows of a
    batch sharded over ``data``, the results the whole batch's (B = b x
    the axis size), on every rank. ``graph`` is a
    :class:`~lnasr_tpu_torch.models.decoder.FactoredDecodingGraph` (or the
    trigram graph: the same surface)."""
    data = mesh_axis(mesh, "data")

    def step(obs, masks):
        paths, scores = graph.decode_batch_arrays(obs, masks)
        return (all_gather(paths, data).flatten(0, 1),
                all_gather(scores, data).flatten(0, 1))

    return step


def decode_batch_sharded(graph, features, masks, mesh
                         ) -> List[Tuple[List[str], np.ndarray, float]]:
    """Decode ``(B, T, D)`` padded feature segments across the mesh's
    ``data`` axis; ``B`` must divide by the axis size. Every rank passes
    the whole batch and gets per-utterance ``(words, path, score)``
    identical to :meth:`FactoredDecodingGraph.decode_batch`."""
    obs = torch.as_tensor(features, dtype=graph.dtype, device=graph.device)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=graph.device)
    data = mesh_axis(mesh, "data")
    step = make_dp_decode_step(mesh, graph)
    return _batch_results(graph, *step(local_rows(obs, data), local_rows(masks, data)))
