"""Experiment trackers (counterpart of ``accelerate_tpu/tracking.py``), kept
as the port's own copy.

The ``GeneralTracker`` interface (``name``, ``requires_logging_directory``,
``tracker``, ``start``, ``store_init_configuration``, ``log``,
``log_batch``, ``finish``), the ``@on_main_process`` guard, a registry with
``register_tracker_class`` and ``filter_trackers``, the dependency-free
``JSONLTracker``, and the backends for tensorboard, wandb, mlflow,
comet_ml, aim, clearml, dvclive, swanlab and trackio, each available only
where its package imports, exactly as in the JAX package.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import time
from typing import Any, Optional

from .logging import get_logger
from .state import process_layout

logger = get_logger(__name__)

__all__ = [
    "GeneralTracker",
    "TensorBoardTracker",
    "WandBTracker",
    "MLflowTracker",
    "CometMLTracker",
    "AimTracker",
    "ClearMLTracker",
    "DVCLiveTracker",
    "SwanLabTracker",
    "TrackioTracker",
    "JSONLTracker",
    "filter_trackers",
    "register_tracker_class",
    "on_main_process",
    "log_registry",
]


def _importable(*names: str):
    """An availability check: whether any of the packages imports."""

    def found(name: str) -> bool:
        try:
            return importlib.util.find_spec(name) is not None
        except (ImportError, ValueError):
            return False

    def available() -> bool:
        return any(found(n) for n in names)

    return available


def log_registry(trackers, registry, step: Optional[int] = None) -> None:
    """Hand one ``registry.snapshot()`` (a dict of metrics) to every
    tracker's ``log_batch``; a tracker's failure is logged, not raised, so
    a metrics flush never stops the worker that calls it."""
    snap = registry.snapshot()
    if not snap:
        return
    entries = [(snap, step, {})]
    for tracker in trackers:
        try:
            tracker.log_batch(entries)
        except Exception as exc:  # tracker I/O must never kill a worker
            logger.error(f"tracker {getattr(tracker, 'name', '?')} "
                         f"registry flush failed: {exc}")


def on_main_process(function):
    """Run only on the main process."""

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        if process_layout()[0] == 0:
            return function(*args, **kwargs)

    return wrapper


class GeneralTracker:
    """The tracker interface."""

    name: str = "general"
    requires_logging_directory: bool = False
    main_process_only: bool = True

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        self.run_name = run_name
        self.logging_dir = logging_dir

    @property
    def tracker(self):
        """The underlying native run object."""
        raise NotImplementedError

    def start(self):
        pass

    def store_init_configuration(self, values: dict):
        pass

    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        raise NotImplementedError

    def log_batch(self, entries):
        """Write several queued records at once. ``entries`` is a list of
        ``(values, step, kwargs)`` tuples (values already materialized to
        host types by the async flusher). Backends override this to batch
        file writes / flushes; the default just replays ``log`` per record."""
        for values, step, kwargs in entries:
            self.log(values, step=step, **kwargs)

    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        pass

    def finish(self):
        pass


class JSONLTracker(GeneralTracker):
    """One JSON line per logged record in ``<logging_dir>/<run>/metrics.jsonl``
    (``_step``, ``_time`` and the values); needs no package."""

    name = "jsonl"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        base = os.path.join(logging_dir or ".", run_name)
        os.makedirs(base, exist_ok=True)
        self.path = os.path.join(base, "metrics.jsonl")
        self._fh = None

    @property
    def tracker(self):
        return self.path

    @on_main_process
    def start(self):
        self._fh = open(self.path, "a")

    @on_main_process
    def store_init_configuration(self, values: dict):
        with open(os.path.join(os.path.dirname(self.path), "config.json"), "w") as f:
            json.dump(values, f, indent=2, default=str)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.log_batch([(values, step, kwargs)])

    @on_main_process
    def log_batch(self, entries):
        # one write + one flush for the whole batch — the async flusher can
        # hand us dozens of steps per wakeup without dozens of syscalls
        if not entries:
            return
        if self._fh is None:
            self.start()
        lines = []
        for values, step, _kwargs in entries:
            rec = {"_step": step, "_time": time.time()}
            rec.update(
                {k: (float(v) if hasattr(v, "__float__") else v) for k, v in values.items()}
            )
            lines.append(json.dumps(rec, default=str))
        self._fh.write("\n".join(lines) + "\n")
        self._fh.flush()

    @on_main_process
    def finish(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TensorBoardTracker(GeneralTracker):
    """TensorBoard via torch.utils.tensorboard or tensorboardX
   ."""

    name = "tensorboard"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        try:
            from torch.utils import tensorboard
        except ImportError:
            import tensorboardX as tensorboard
        self._writer_cls = tensorboard.SummaryWriter
        self.writer = None
        self._kwargs = kwargs

    @property
    def tracker(self):
        return self.writer

    @on_main_process
    def start(self):
        self.writer = self._writer_cls(
            os.path.join(self.logging_dir or ".", self.run_name), **self._kwargs
        )

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.writer.add_hparams(
            {k: v for k, v in values.items() if isinstance(v, (int, float, str, bool))}, {}
        )
        self.writer.flush()

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.log_batch([(values, step, kwargs)])

    @on_main_process
    def log_batch(self, entries):
        # all scalars for the batch land in the event file behind a single
        # flush, instead of one flush per step
        if not entries:
            return
        for values, step, kwargs in entries:
            for k, v in values.items():
                if isinstance(v, str):
                    self.writer.add_text(k, v, global_step=step)
                elif isinstance(v, dict):
                    self.writer.add_scalars(k, v, global_step=step)
                else:
                    self.writer.add_scalar(k, float(v), global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        import numpy as np

        kwargs.setdefault("dataformats", "NHWC")
        for k, v in values.items():
            self.writer.add_images(k, np.asarray(v), global_step=step, **kwargs)
        self.writer.flush()

    @on_main_process
    def finish(self):
        if self.writer is not None:
            self.writer.close()


class WandBTracker(GeneralTracker):
    """Weights & Biases."""

    name = "wandb"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.run = None

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def start(self):
        import wandb

        self.run = wandb.init(project=self.run_name, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        import wandb

        wandb.config.update(values, allow_val_change=True)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step, **kwargs)

    @on_main_process
    def log_images(self, values: dict, step: Optional[int] = None, **kwargs):
        import wandb

        self.run.log(
            {k: [wandb.Image(img, **kwargs) for img in v] for k, v in values.items()},
            step=step,
        )

    @on_main_process
    def finish(self):
        if self.run is not None:
            self.run.finish()


class MLflowTracker(GeneralTracker):
    """MLflow."""

    name = "mlflow"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.run = None

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def start(self):
        import mlflow

        exp = mlflow.set_experiment(self.run_name)
        self.run = mlflow.start_run(experiment_id=exp.experiment_id, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        import mlflow

        for k, v in values.items():
            mlflow.log_param(k, v)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        import mlflow

        mlflow.log_metrics(
            {k: float(v) for k, v in values.items() if isinstance(v, (int, float))}, step=step
        )

    @on_main_process
    def finish(self):
        import mlflow

        mlflow.end_run()


class CometMLTracker(GeneralTracker):
    """Comet ML."""

    name = "comet_ml"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.experiment = None

    @property
    def tracker(self):
        return self.experiment

    @on_main_process
    def start(self):
        import comet_ml

        self.experiment = comet_ml.Experiment(project_name=self.run_name, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.experiment.log_parameters(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.experiment.set_step(step)
        self.experiment.log_metrics(values, step=step, **kwargs)

    @on_main_process
    def finish(self):
        if self.experiment is not None:
            self.experiment.end()


class AimTracker(GeneralTracker):
    """Aim."""

    name = "aim"
    requires_logging_directory = True

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.run = None

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def start(self):
        from aim import Run

        self.run = Run(repo=self.logging_dir, experiment=self.run_name, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.run["hparams"] = values

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        for k, v in values.items():
            self.run.track(v, name=k, step=step, **kwargs)

    @on_main_process
    def finish(self):
        if self.run is not None:
            self.run.close()


class ClearMLTracker(GeneralTracker):
    """ClearML."""

    name = "clearml"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.task = None

    @property
    def tracker(self):
        return self.task

    @on_main_process
    def start(self):
        from clearml import Task

        self.task = Task.init(project_name=self.run_name, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.task.connect_configuration(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        clogger = self.task.get_logger()
        for k, v in values.items():
            clogger.report_scalar(title=k, series=k, value=float(v), iteration=step or 0)

    @on_main_process
    def finish(self):
        if self.task is not None:
            self.task.close()


class DVCLiveTracker(GeneralTracker):
    """DVC Live."""

    name = "dvclive"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, live=None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.live = live

    @property
    def tracker(self):
        return self.live

    @on_main_process
    def start(self):
        if self.live is None:
            from dvclive import Live

            self.live = Live(**self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.live.log_params(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        if step is not None:
            self.live.step = step
        for k, v in values.items():
            self.live.log_metric(k, float(v))
        self.live.next_step()

    @on_main_process
    def finish(self):
        if self.live is not None:
            self.live.end()


class SwanLabTracker(GeneralTracker):
    """SwanLab."""

    name = "swanlab"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.run = None

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def start(self):
        import swanlab

        self.run = swanlab.init(project=self.run_name, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        import swanlab

        swanlab.config.update(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values, step=step)

    @on_main_process
    def finish(self):
        import swanlab

        swanlab.finish()


class TrackioTracker(GeneralTracker):
    """trackio."""

    name = "trackio"
    requires_logging_directory = False

    def __init__(self, run_name: str, logging_dir: Optional[str] = None, **kwargs):
        super().__init__(run_name, logging_dir)
        self._kwargs = kwargs
        self.run = None

    @property
    def tracker(self):
        return self.run

    @on_main_process
    def start(self):
        import trackio

        self.run = trackio.init(project=self.run_name, **self._kwargs)

    @on_main_process
    def store_init_configuration(self, values: dict):
        self.run.config.update(values)

    @on_main_process
    def log(self, values: dict, step: Optional[int] = None, **kwargs):
        self.run.log(values)

    @on_main_process
    def finish(self):
        import trackio

        trackio.finish()


_TRACKERS: dict[str, tuple[type, Any]] = {
    "jsonl": (JSONLTracker, lambda: True),
    "tensorboard": (TensorBoardTracker, _importable("tensorboardX", "tensorboard",
                                                          "torch.utils.tensorboard")),
    "wandb": (WandBTracker, _importable("wandb")),
    "mlflow": (MLflowTracker, _importable("mlflow")),
    "comet_ml": (CometMLTracker, _importable("comet_ml")),
    "aim": (AimTracker, _importable("aim")),
    "clearml": (ClearMLTracker, _importable("clearml")),
    "dvclive": (DVCLiveTracker, _importable("dvclive")),
    "swanlab": (SwanLabTracker, _importable("swanlab")),
    "trackio": (TrackioTracker, _importable("trackio")),
}


def register_tracker_class(name: str, tracker_cls: type, availability=lambda: True):
    """Register a custom tracker backend."""
    _TRACKERS[name] = (tracker_cls, availability)


def filter_trackers(log_with: list, logging_dir: Optional[str] = None) -> list[type]:
    """The tracker classes of ``log_with`` whose packages import (the others
    are skipped with a warning); ``"all"`` selects every available one."""
    if not log_with:
        return []
    names = []
    for entry in log_with:
        if isinstance(entry, GeneralTracker):
            names.append(entry)
            continue
        entry = str(entry).lower()
        if entry == "all":
            names.extend(n for n, (_, avail) in _TRACKERS.items() if avail())
        else:
            names.append(entry)
    out = []
    for name in names:
        if isinstance(name, GeneralTracker):
            out.append(type(name))
            continue
        if name not in _TRACKERS:
            raise ValueError(f"Unknown tracker {name!r}; known: {sorted(_TRACKERS)}")
        cls, avail = _TRACKERS[name]
        if not avail():
            logger.warning(f"Tracker {name} requested but its package is unavailable; skipping")
            continue
        if cls.requires_logging_directory and logging_dir is None:
            raise ValueError(f"Tracker {name} requires a logging_dir")
        out.append(cls)
    return out
