"""Curriculum-aware data sampler and offline difficulty analyzer.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``
(reference ``runtime/data_pipeline/data_sampling/``), host-only numpy:

* ``DataAnalyzer`` (reference ``data_analyzer.py``): an offline
  map-reduce pass computing a difficulty metric per sample and
  persisting the metric values and a difficulty-sorted sample index;
* ``DeepSpeedDataSampler`` (reference ``data_sampler.py:36``): at each
  step, admit only samples whose difficulty is at most the curriculum's
  current threshold, shuffle deterministically and shard across
  data-parallel ranks.  ``state_dict`` / ``load_state_dict`` carry the
  step, seed and curriculum, so a resume (the dict rides in a
  checkpoint's ``client_state``) continues the same index order.

Batches keep their size: the eligible pool only grows (curriculum
difficulty is monotone), and the model never sees the curriculum, which
is pure host-side index selection.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, List, Sequence

import numpy as np

from ...utils.logging import logger


class DataAnalyzer:
    """Offline difficulty indexing (reference ``DataAnalyzer``)."""

    def __init__(self, dataset: Sequence[Any], metric_fns: Dict[str, Callable[[Any], float]],
                 save_path: str, num_workers: int = 1, worker_id: int = 0):
        self.dataset = dataset
        self.metric_fns = metric_fns
        self.save_path = save_path
        self.num_workers = num_workers
        self.worker_id = worker_id

    def _paths(self, metric: str):
        base = os.path.join(self.save_path, metric)
        return base + "_metric_values.npy", base + "_sample_to_metric.npy"

    def _worker_path(self, metric: str, worker: int) -> str:
        return os.path.join(self.save_path,
                            f"{metric}_metric_values.worker{worker}.npy")

    @staticmethod
    def _atomic_save(path: str, arr: np.ndarray) -> None:
        tmp = f"{path}.{os.getpid()}.tmp.npy"  # .npy suffix: np.save appends otherwise
        np.save(tmp, arr)
        os.replace(tmp, path)

    def run_map(self) -> None:
        """Compute metrics over this worker's shard into a per-worker file.

        Each worker owns its file exclusively (no shared read-modify-write
        — the reference's map/reduce split, data_analyzer.py run_map), so
        concurrent workers cannot lose updates."""
        os.makedirs(self.save_path, exist_ok=True)
        n = len(self.dataset)
        shard = range(self.worker_id, n, self.num_workers)
        for name, fn in self.metric_fns.items():
            values = np.full(n, np.nan, np.float64)
            for i in shard:
                values[i] = float(fn(self.dataset[i]))
            self._atomic_save(self._worker_path(name, self.worker_id), values)

    def run_reduce(self, strict: bool = True) -> bool:
        """Merge all workers' shard files into the final metric files.

        Idempotent and deterministic: whichever worker(s) see the full set
        of shard files write byte-identical output via atomic rename.
        Returns True if the merge completed."""
        done = True
        for name in self.metric_fns:
            paths = [self._worker_path(name, w) for w in range(self.num_workers)]
            missing = [p for p in paths if not os.path.exists(p)]
            if missing:
                if strict:
                    raise FileNotFoundError(
                        f"DataAnalyzer reduce: missing worker shards {missing}")
                done = False
                continue
            values = np.load(paths[0])
            for p in paths[1:]:
                shard_vals = np.load(p)
                mask = ~np.isnan(shard_vals)
                values[mask] = shard_vals[mask]
            vals_path, s2m_path = self._paths(name)
            self._atomic_save(vals_path, values)
            if not np.isnan(values).any():
                self._atomic_save(s2m_path, np.argsort(values, kind="stable"))
        return done

    def run_map_reduce(self) -> None:
        """Map this worker's shard, then merge if every shard is present
        (the last worker to finish completes the merge; single-process
        path computes everything)."""
        self.run_map()
        if self.run_reduce(strict=False):
            logger.info("DataAnalyzer: wrote metrics %s to %s",
                        sorted(self.metric_fns), self.save_path)

    @staticmethod
    def load(save_path: str, metric: str):
        base = os.path.join(save_path, metric)
        return (np.load(base + "_metric_values.npy"),
                np.load(base + "_sample_to_metric.npy"))


class DeepSpeedDataSampler:
    """Curriculum batch sampler (reference ``DeepSpeedDataSampler``).

    Yields per-step lists of *global sample indices* for this DP rank.
    """

    def __init__(self,
                 difficulties: np.ndarray,
                 curriculum_scheduler,
                 global_batch_size: int,
                 data_parallel_rank: int = 0,
                 data_parallel_size: int = 1,
                 drop_last: bool = True,
                 seed: int = 1234):
        if global_batch_size % data_parallel_size:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"dp size {data_parallel_size}")
        self.difficulties = np.asarray(difficulties, np.float64)
        self.sorted_idx = np.argsort(self.difficulties, kind="stable")
        self.sorted_vals = self.difficulties[self.sorted_idx]
        self.scheduler = curriculum_scheduler
        self.global_batch_size = global_batch_size
        self.dp_rank = data_parallel_rank
        self.dp_size = data_parallel_size
        self.micro = global_batch_size // data_parallel_size
        self.drop_last = drop_last
        self.seed = seed
        self.global_step = 0
        self._consumed = 0  # within the current eligible pool epoch

    def eligible_count(self) -> int:
        d = self.scheduler.update_difficulty(self.global_step)
        return int(np.searchsorted(self.sorted_vals, d, side="right"))

    def __iter__(self) -> Iterator[List[int]]:
        return self

    def __next__(self) -> List[int]:
        n_elig = self.eligible_count()
        if n_elig < self.global_batch_size:
            # too few easy samples yet: fall back to the easiest batch-size
            # pool (reference keeps training rather than starving; an empty
            # pool would crash rng.choice regardless of drop_last)
            n_elig = min(len(self.sorted_idx), self.global_batch_size)
        pool = self.sorted_idx[:n_elig]
        # deterministic shuffle that changes per step but is stable across
        # ranks (same seed -> same permutation; rank slices differ)
        rng = np.random.default_rng(self.seed + self.global_step)
        picks = rng.choice(pool.size, size=self.global_batch_size,
                           replace=pool.size < self.global_batch_size)
        batch = pool[picks]
        shard = batch[self.dp_rank * self.micro:(self.dp_rank + 1) * self.micro]
        self.global_step += 1
        return [int(i) for i in shard]

    # ------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        return {"global_step": self.global_step, "seed": self.seed,
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.global_step = int(sd["global_step"])
        self.seed = int(sd["seed"])
        self.scheduler.load_state_dict(sd["scheduler"])
