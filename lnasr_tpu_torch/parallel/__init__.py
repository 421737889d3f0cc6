"""Multi-rank execution on ``torch.distributed``: meshes, data-, model-,
sequence- and pipeline-parallel EM and decoding.

The counterpart of the JAX package's ``parallel/``, one process per rank
(SPMD) instead of one controller over a device mesh. Every rank calls the
same function with the same global inputs (made from the same seed),
works on its own shard by its mesh coordinate, and returns what the JAX
function returns. Parallelism maps onto a named rank mesh (a
``DeviceMesh``, :mod:`lnasr_tpu_torch.parallel.mesh`):

- ``data``: utterance batches shard here; Baum-Welch sufficient
  statistics are summed (``psum``), batch decodes gathered;
- ``seq``: long utterances chunk along time; the forward recursion's
  associative (N, N) operators compose across chunks with one small
  all-gather;
- ``model``: GMM mixture components shard here;
- ``stage``: streaming pipeline parallelism (:mod:`.pipeline`).

:mod:`.distributed` joins a process to a world (NCCL when every rank has
a card of its own, gloo otherwise), spawns worlds (:func:`~.distributed.
run_ranks`) and holds the collectives. On CUDA each rank's shard runs the
port's normal paths: the sharded decode launches the factored forward and
replay-backtrace kernels once per utterance on every rank.
"""

from lnasr_tpu_torch.parallel.mesh import make_mesh, mesh_shape_for
from lnasr_tpu_torch.parallel.training import (
    make_dp_gmmhmm_em_step,
    make_dp_hmm_em_step,
    make_seq_gmmhmm_em_step,
    make_seq_hmm_em_step,
    train_data_parallel,
    train_seq_parallel,
)
from lnasr_tpu_torch.parallel.seqscan import (
    backward_seq_parallel,
    forward_seq_parallel,
    viterbi_seq_parallel,
)
from lnasr_tpu_torch.parallel.model_parallel import (
    make_mp_emission_fn,
    make_mp_gmmhmm_em_step,
    mp_param_specs,
    train_model_parallel,
)
from lnasr_tpu_torch.parallel.serving import (
    decode_batch_sharded,
    make_dp_decode_step,
)
from lnasr_tpu_torch.parallel.pipeline import (
    make_stage_mesh,
    streaming_pipeline_decode,
    streaming_pipeline_scores,
)

__all__ = [
    "decode_batch_sharded",
    "make_dp_decode_step",
    "make_stage_mesh",
    "streaming_pipeline_decode",
    "streaming_pipeline_scores",
    "make_mesh",
    "mesh_shape_for",
    "make_dp_gmmhmm_em_step",
    "make_dp_hmm_em_step",
    "train_data_parallel",
    "backward_seq_parallel",
    "forward_seq_parallel",
    "make_seq_gmmhmm_em_step",
    "make_seq_hmm_em_step",
    "train_seq_parallel",
    "viterbi_seq_parallel",
    "make_mp_emission_fn",
    "make_mp_gmmhmm_em_step",
    "mp_param_specs",
    "train_model_parallel",
]
