"""Multi-process generation cluster: stripe one DatasetJob across N
worker processes and merge the results into a single valid dataset.

The coordinator never generates a byte itself.  The plan is computed
once (by the CLI, before the coordinator starts); each **round** the
coordinator:

1. **syncs** — loads the manifest, strictly merges every per-worker
   journal (``Manifest.merge_worker_journals``: a shard committed by
   two different journals raises — overlapping stripes are a bug, not
   a race to tolerate), compacts the merged state into
   ``manifest.json`` and deletes the worker journals, so workers
   always start against a clean manifest + fresh journals;
2. **re-stripes** — if workers died last round, shrinks the recorded
   ``num_workers`` to the survivor count (min 1) and re-saves the
   manifest; the striping is num_workers-independent in shard
   *composition*, so the remaining pending shards redistribute across
   survivor queues with identical bytes (per-shard seeds are
   placement-invariant);
3. **spawns** one :class:`repro_torch.distributed.launcher.WorkerProcess`
   per stripe (``--worker-id k``), each appending completions to its
   own ``journal.w{k}.jsonl`` and never rewriting ``manifest.json``;
4. **watches** — tails journals for progress and process liveness until
   every worker exits.  A live worker that commits no shard for
   ``heartbeat_timeout_s`` is SIGKILLed as stalled, so a hung worker
   ends its round like a dead one (optionally workers are also killed
   after a committed-shard threshold: the fault-injection hook the
   crash-rebalance tests and the smoke drive).

Rounds repeat until the manifest is complete.  A round that commits
nothing while work is still pending raises instead of spinning — with
or without deaths (a worker that cannot start, e.g. ``--device cuda``
with no card visible, or one that hangs, fails the run rather than
being retried).  The
result is byte-identical to the single-process run: same shard files,
same manifest modulo executor/worker provenance.

The coordinator plans and merges only: it never generates a byte, and
never touches a CUDA device (the workers each hold their own context on
the card).
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.datastream.writer import (Manifest, worker_journal_name,
                                           worker_journal_paths)
from repro_torch.distributed.launcher import WorkerProcess

__all__ = ["ClusterCoordinator", "ClusterError"]


class ClusterError(RuntimeError):
    """Coordinator-level failure (stuck cluster, merge conflict...)."""


class ClusterCoordinator:
    """Drive one planned dataset to completion across worker processes.

    ``worker_argv(worker_id, num_workers)`` builds the spawn command
    for one stripe of the *current* round — the coordinator re-invokes
    it with the shrunken worker count after deaths.

    ``heartbeat_timeout_s``: the longest a live worker may go without
    committing a shard (its start included) before it is killed as
    stalled.

    ``kill_after`` maps ``worker_id -> n``: kill that worker (SIGKILL)
    once its journal shows ``n`` committed shards.  Each entry fires at
    most once across the whole run — it exists to make crash-rebalance
    deterministic in tests and the smoke, not as a control feature.
    """

    def __init__(self, out_dir: str,
                 worker_argv: Callable[[int, int], Sequence[str]],
                 num_workers: int,
                 poll_s: float = 0.1,
                 heartbeat_timeout_s: float = 600.0,
                 max_rounds: int = 8,
                 kill_after: Optional[Dict[int, int]] = None,
                 log: Optional[Callable[[str], None]] = None):
        if num_workers < 1:
            raise ValueError(f"num_workers={num_workers} < 1")
        self.out_dir = out_dir
        self.worker_argv = worker_argv
        self.num_workers = int(num_workers)
        self.poll_s = float(poll_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_rounds = int(max_rounds)
        self._kill_after = dict(kill_after or {})
        self._log = log or (lambda msg: None)
        # run report: per-round spawn/merge/death stats, filled by run()
        self.report: Dict[str, Any] = {"rounds": [], "wall_s": 0.0,
                                       "num_workers": self.num_workers}

    # -- sync: merge worker journals into the authoritative manifest ------
    def _sync(self) -> Manifest:
        manifest = Manifest.load(self.out_dir)
        stats = manifest.merge_worker_journals(self.out_dir)
        manifest.save(self.out_dir)
        for path in worker_journal_paths(self.out_dir):
            os.remove(path)
        if stats:
            merged = sum(s["shards"] for s in stats.values())
            self._log(f"merged {merged} shard(s) from "
                      f"{len(stats)} worker journal(s)")
        return manifest

    def _pending(self, manifest: Manifest) -> int:
        return sum(1 for s in manifest.shards if s.status != "done")

    # -- watch: one round of worker processes ------------------------------
    def _watch(self, procs: List[WorkerProcess]) -> Dict[int, Dict[str, Any]]:
        """Tail journals + liveness until every worker exits.  Returns
        per-worker ``{"shards", "edges", "returncode", "killed",
        "stalled"}``."""
        t0 = time.monotonic()
        state = {p.worker_id: {"shards": 0, "edges": 0, "returncode": None,
                               "killed": False, "stalled": False,
                               "last_progress_s": t0}
                 for p in procs}
        live = list(procs)
        while live:
            time.sleep(self.poll_s)
            now = time.monotonic()
            still = []
            for p in live:
                st = state[p.worker_id]
                exited = not p.alive()
                # poll after the liveness check: records appended just
                # before exit are still collected on this final pass
                for rec in p.poll_journal():
                    if rec.get("status") == "done":
                        st["shards"] += 1
                        st["edges"] += int(rec.get("n_edges", 0))
                        st["last_progress_s"] = now
                threshold = self._kill_after.get(p.worker_id)
                if threshold is not None and st["shards"] >= threshold \
                        and not exited:
                    del self._kill_after[p.worker_id]
                    self._log(f"fault injection: killing worker "
                              f"{p.worker_id} after {st['shards']} shards")
                    p.kill()
                    st["killed"] = True
                    exited = True
                if not exited and (now - st["last_progress_s"]
                                   > self.heartbeat_timeout_s):
                    self._log(f"worker {p.worker_id} committed no shard "
                              f"for {self.heartbeat_timeout_s:.0f}s — "
                              f"killing it as stalled")
                    p.kill()
                    st["stalled"] = st["killed"] = True
                    exited = True
                if exited:
                    st["returncode"] = p.wait()
                    continue
                still.append(p)
            live = still
        for st in state.values():
            del st["last_progress_s"]
        return state

    # -- the round loop ----------------------------------------------------
    def run(self) -> Manifest:
        if not Manifest.exists(self.out_dir):
            raise ClusterError(
                f"{self.out_dir} has no manifest — plan the job before "
                "starting the coordinator")
        t_run = time.monotonic()
        workers = self.num_workers
        procs: List[WorkerProcess] = []
        try:
            for round_id in range(self.max_rounds):
                manifest = self._sync()
                pending = self._pending(manifest)
                if pending == 0:
                    break
                if manifest.num_workers != workers:
                    # re-stripe: survivors recompute their queues from
                    # the recorded num_workers, so it must match the
                    # worker count we are about to spawn
                    manifest.num_workers = workers
                    manifest.save(self.out_dir)
                self._log(f"round {round_id}: {pending} shard(s) pending "
                          f"across {workers} worker(s)")
                t_round = time.monotonic()
                procs = [
                    WorkerProcess(
                        w, self.worker_argv(w, workers),
                        journal_path=os.path.join(
                            self.out_dir, worker_journal_name(w)),
                        log_dir=self.out_dir)
                    for w in range(workers)]
                state = self._watch(procs)
                procs = []
                deaths = sum(1 for st in state.values()
                             if st["returncode"] != 0)
                committed = sum(st["shards"] for st in state.values())
                self.report["rounds"].append({
                    "round": round_id, "num_workers": workers,
                    "wall_s": time.monotonic() - t_round,
                    "shards": committed,
                    "edges": sum(st["edges"] for st in state.values()),
                    "deaths": deaths,
                    "workers": {str(w): st for w, st in
                                sorted(state.items())}})
                if committed == 0:
                    raise ClusterError(
                        f"round {round_id} committed no shards with "
                        f"{pending} still pending and {deaths} worker "
                        "death(s) — the cluster is stuck; see worker logs "
                        f"in {self.out_dir}")
                if deaths:
                    self._log(f"round {round_id}: {deaths} worker(s) died "
                              f"— re-striping across "
                              f"{max(1, workers - deaths)} survivor(s)")
                    workers = max(1, workers - deaths)
            else:
                raise ClusterError(
                    f"dataset incomplete after max_rounds="
                    f"{self.max_rounds} rounds")
            manifest = self._sync()
            if not manifest.is_complete():
                raise ClusterError("coordinator loop exited with "
                                   "incomplete manifest (bug)")
            self.report["wall_s"] = time.monotonic() - t_run
            self.report["done_edges"] = manifest.done_edges()
            return manifest
        finally:
            for p in procs:          # coordinator died mid-round: don't
                p.kill()             # orphan the workers
