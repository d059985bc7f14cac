"""Streaming dataset materialization (generation → disk → training).

The in-memory paths (``rmat.sample_graph*``,
``SyntheticGraphPipeline.generate``) cap out at what fits in memory.  This
subsystem turns the chunked sampler into a dataset *service* that writes
the JAX package's sharded format, byte for byte where the streams agree,
split into focused layers:

* ``scheduler`` — deterministic chunk → shard → worker planning
* ``source``    — ``ShardSource``: one shard's structure (and
  ``FeatureSpec``: its features) as a pure ``(fit, seed, shard_id)``
  function; ``ChunkShardSource`` vs ``DeviceStepShardSource``
* ``executor``  — ``ShardExecutor``: the staged pipeline overlapping
  struct sampling on the card, the feature draw and alignment, and the
  writer's flush (byte-identical to the serial loop, which
  ``pipeline_depth=0`` runs)
* ``writer``    — sharded on-disk store, journaled progress, async flush
* ``reader``    — manifest-driven mmap-ed access + streamed deep verify
* ``service``   — ``DatasetJob``: the resumable plan→run→verify facade

    from repro_torch.datastream import DatasetJob, ShardedGraphDataset

    job = DatasetJob(fit, out_dir="/data/ds", shard_edges=1 << 20,
                     pipeline_depth=2, host_workers=2)   # on "cuda"
    job.run()                       # or job.resume() after an interrupt
    ds = ShardedGraphDataset("/data/ds")
    for block in ds:                # bounded-memory iteration
        train_step(block.src, block.dst, block.cont)
"""
from repro_torch.datastream.executor import ExecutorStats, ShardExecutor
from repro_torch.datastream.reader import ShardBlock, ShardedGraphDataset
from repro_torch.datastream.scheduler import (ChunkScheduler, ShardPlan,
                                              auto_k_pref)
from repro_torch.datastream.service import DatasetJob
from repro_torch.datastream.source import (ChunkShardSource,
                                           DeviceStepShardSource,
                                           FeatureSpec, ShardSource)
from repro_torch.datastream.writer import (MANIFEST_NAME, AsyncFlushQueue,
                                           Manifest, ShardRecord,
                                           ShardWriter, pump_chunks,
                                           worker_journal_name,
                                           worker_journal_paths)

__all__ = [
    "ChunkScheduler", "ShardPlan", "auto_k_pref",
    "Manifest", "ShardRecord", "ShardWriter", "AsyncFlushQueue",
    "pump_chunks", "MANIFEST_NAME",
    "worker_journal_name", "worker_journal_paths",
    "ShardedGraphDataset", "ShardBlock",
    "ShardSource", "ChunkShardSource", "DeviceStepShardSource",
    "ShardExecutor", "ExecutorStats",
    "DatasetJob", "FeatureSpec",
]
