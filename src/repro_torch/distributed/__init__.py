"""Distributed runtime of the port: a gang of processes joined by
``torch.distributed``, each one rank of a cartesian block decomposition
(``launch.mesh.RankMesh``) holding its local fields with ghost rings.

  * ``halo``: ghost-ring exchange (per axis and direction, grouped per
    dtype, per-field depths, bf16/int8 wire formats, host-staged over gloo
    for CUDA tensors, direct over NCCL);
  * ``overlap``: the steps, ``sequential_step``, ``multi_step`` (one deep
    exchange, then the k-step kernel) and ``overlapped_step`` (the
    paper's ``@hide_communication``, stream-structured), with the check's
    reductions combined across ranks;
  * ``elastic``: the distributed, checkpointing ``elastic_solve_until``,
    the decomposition policy and the restart policy;
  * ``compression``: int8 block quantization and the error-feedback int8
    all-reduce;
  * ``fault``: retry, fault injection, heartbeats and step monitoring.

The launcher and rendezvous live in ``launch.multihost``. Not ported: the
LM's sharding (``distributed/sharding.py``) and the parameter re-sharding
of ``elastic`` (``remesh``, ``from_host_callback``,
``validate_divisibility``), which wait for the LM's sharded training.
"""
from . import compression, elastic, fault, halo, overlap

__all__ = ["compression", "elastic", "fault", "halo", "overlap"]
