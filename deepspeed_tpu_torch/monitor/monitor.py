"""Monitoring backends.

Counterpart of ``deepspeed_tpu/monitor/monitor.py`` (reference
``deepspeed/monitor/``): :class:`MonitorMaster` fans ``write_events``
out to TensorBoard, CSV, Weights & Biases and Comet writers, and
:meth:`MonitorMaster.write_registry_snapshot` publishes the telemetry
registry under ``Telemetry/<metric>`` tags.  The TensorBoard, W&B and
Comet writers import their package when enabled and disable themselves
with a warning when it is missing (the card's machine has none of them);
the CSV writer needs nothing.  One rank writes: the port trains on one.
"""

from __future__ import annotations

import csv
import os
from typing import Any, List, Tuple

from ..utils.logging import logger

Event = Tuple[str, Any, int]  # (tag, value, step)


class Monitor:
    def __init__(self, config):
        self.enabled = config.enabled

    def write_events(self, event_list: List[Event]) -> None:
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
                log_dir = os.path.join(config.output_path or "./runs",
                                       config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
            except Exception as e:
                logger.warning("tensorboard unavailable: %s", e)
                self.enabled = False

    def write_events(self, event_list: List[Event]) -> None:
        if self.summary_writer is None:
            return
        for tag, value, step in event_list:
            self.summary_writer.add_scalar(tag, float(value), int(step))
        self.summary_writer.flush()


class CSVMonitor(Monitor):
    """One ``<output_path>/<job_name>/<tag with / as _>.csv`` per tag,
    rows ``step, value`` under a ``step, <tag>`` header; one open append
    handle per tag, flushed once per ``write_events`` batch."""

    def __init__(self, config):
        super().__init__(config)
        self.output_path = config.output_path or "./csv_monitor"
        self.job_name = config.job_name
        self._files = {}

    def _writer(self, tag: str):
        entry = self._files.get(tag)
        if entry is None:
            fname = os.path.join(self.output_path, self.job_name,
                                 tag.replace("/", "_") + ".csv")
            os.makedirs(os.path.dirname(fname), exist_ok=True)
            new = not os.path.exists(fname) or os.path.getsize(fname) == 0
            f = open(fname, "a", newline="")
            w = csv.writer(f)
            if new:
                w.writerow(["step", tag])
            entry = self._files[tag] = (f, w)
        return entry

    def write_events(self, event_list: List[Event]) -> None:
        if not self.enabled:
            return
        touched = []
        for tag, value, step in event_list:
            f, w = self._writer(tag)
            w.writerow([int(step), float(value)])
            touched.append(f)
        for f in touched:
            f.flush()

    def close(self) -> None:
        for f, _ in self._files.values():
            f.close()
        self._files.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class WandbMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if self.enabled:
            try:
                import wandb
                wandb.init(project=config.project or "deepspeed_tpu",
                           group=config.group or None,
                           team=config.team or None)
                self._wandb = wandb
            except Exception as e:
                logger.warning("wandb unavailable: %s", e)
                self.enabled = False

    def write_events(self, event_list: List[Event]) -> None:
        if self._wandb is None:
            return
        for tag, value, step in event_list:
            self._wandb.log({tag: value}, step=int(step))


class CometMonitor(Monitor):
    """Comet experiment writer (reference ``monitor/comet.py``)."""

    def __init__(self, config):
        super().__init__(config)
        self._exp = None
        if self.enabled:
            try:
                import comet_ml
                self._exp = comet_ml.Experiment(
                    project_name=config.project or "deepspeed_tpu",
                    workspace=config.team or None)
                if config.job_name:
                    self._exp.set_name(config.job_name)
            except Exception as e:
                logger.warning("comet_ml unavailable: %s", e)
                self.enabled = False

    def write_events(self, event_list: List[Event]) -> None:
        if self._exp is None:
            return
        for tag, value, step in event_list:
            self._exp.log_metric(tag, value, step=int(step))


class MonitorMaster(Monitor):
    """Fan-out master (reference ``monitor/monitor.py:30``) over the
    config's ``tensorboard``, ``csv_monitor``, ``wandb`` and ``comet``
    sections."""

    def __init__(self, ds_config):
        self.monitors: List[Monitor] = []
        if ds_config.tensorboard.enabled:
            self.monitors.append(TensorBoardMonitor(ds_config.tensorboard))
        if ds_config.csv_monitor.enabled:
            self.monitors.append(CSVMonitor(ds_config.csv_monitor))
        if ds_config.wandb.enabled:
            self.monitors.append(WandbMonitor(ds_config.wandb))
        if ds_config.comet.enabled:
            self.monitors.append(CometMonitor(ds_config.comet))
        self.enabled = any(m.enabled for m in self.monitors)

    def write_events(self, event_list: List[Event]) -> None:
        for m in self.monitors:
            if m.enabled:
                m.write_events(event_list)

    def write_registry_snapshot(self, step: int) -> None:
        """The telemetry registry through every enabled writer under
        ``Telemetry/<metric>`` tags (the names ``/metrics`` serves);
        metrics that never recorded anything are skipped."""
        if not self.enabled:
            return
        from ..telemetry import Counter, Gauge, Histogram, get_registry
        events: List[Event] = []
        for name, m in sorted(get_registry().all_metrics().items()):
            if isinstance(m, Histogram):
                if m.count == 0:
                    continue
                events += [(f"Telemetry/{name}_p50", m.percentile(50), step),
                           (f"Telemetry/{name}_p90", m.percentile(90), step),
                           (f"Telemetry/{name}_p99", m.percentile(99), step),
                           (f"Telemetry/{name}_count", m.count, step),
                           (f"Telemetry/{name}_mean", m.mean, step)]
            elif isinstance(m, Counter):
                if m.value:
                    events.append((f"Telemetry/{name}", m.value, step))
            elif isinstance(m, Gauge):
                if m.touched:
                    events.append((f"Telemetry/{name}", m.value, step))
        self.write_events(events)
