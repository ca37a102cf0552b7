"""Monitoring backends (counterpart of ``deepspeed_tpu/monitor``)."""

from .monitor import (CometMonitor, CSVMonitor, MonitorMaster,  # noqa: F401
                      TensorBoardMonitor, WandbMonitor)
