"""torchtlc.dist: pods of the sharded engine across torch.distributed
processes (port of jaxtlc/dist).

One process per host, D = devices_per_host x processes fingerprint-space
shards laid out process-major, the same sharded engine body throughout:
the candidate and verdict exchanges are all_to_all calls (kernels K36 and
K37 lay the candidates out), the fences one all_gather a body (kernel K38
packs the columns).  This package adds what distribution needs on top:

* `pod.init_pod` / `pod.pod_mesh` - the group (gloo or NCCL, chosen
  explicitly) and the pod's ShardMesh;
* `pod.run_pod` - one pod member's run: segment loop, per-host journals
  (``{base}.h{pid}.journal.jsonl``, merged by obs.serve's /runs registry
  and obs.views.merge_journals), per-host shard checkpoints
  (``{base}.h{pid}``, the reference's files), SIGTERM consensus (a
  pod-wide vote, every host checkpoints, exit 75) and the per-host
  SpillStore lifeboat (``spill="on"``);
* `pod.reshard_carry` - resume at another pod width: saved tables and
  frontier re-partitioned by the new owner mapping hi & (D'-1).

`python -m torchtlc.dist --spawn N` launches an N-process localhost pod;
see __main__.py.
"""

from .pod import (  # noqa: F401
    DEFAULT_COORDINATOR,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_VIOLATION,
    PodResult,
    host_checkpoint_path,
    host_journal_path,
    init_pod,
    pod_mesh,
    reshard_carry,
    run_pod,
)
