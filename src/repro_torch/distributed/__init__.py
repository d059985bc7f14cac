"""Multi-process generation: one planned ``DatasetJob`` striped across
worker processes (``launcher.WorkerProcess``) and merged into one dataset
by ``cluster.ClusterCoordinator``, byte-identical to the serial run.
``python -m repro_torch.scripts.generate_dataset --num-workers K`` drives
it."""
from repro_torch.distributed.cluster import (  # noqa: F401
    ClusterCoordinator, ClusterError)
from repro_torch.distributed.launcher import (  # noqa: F401
    WorkerProcess, python_argv, repro_torch_pythonpath, worker_env,
    worker_log_name)

__all__ = ["ClusterCoordinator", "ClusterError", "WorkerProcess",
           "python_argv", "repro_torch_pythonpath", "worker_env",
           "worker_log_name"]
