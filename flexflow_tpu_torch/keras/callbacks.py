"""Keras-style callbacks: the JAX package's keras/callbacks.py (after
FlexFlow's python/flexflow/keras/callbacks.py — Callback protocol,
LearningRateScheduler, EarlyStopping, VerifyMetrics,
EpochVerifyMetrics), and ModelCheckpoint over the port's
runtime/checkpoint.py, whose snapshots both packages read."""

from __future__ import annotations

from typing import Callable, Dict, Optional


class Callback:
    def set_model(self, model) -> None:
        self.model = model

    @property
    def ffmodel(self):
        """The underlying FFModel regardless of fit entry point: keras
        ``Model.fit`` binds the keras wrapper (which holds ``.ffmodel``),
        ``FFModel.fit`` binds the FFModel itself."""
        return getattr(self.model, "ffmodel", None) or self.model

    def on_train_begin(self) -> None:
        pass

    def on_train_end(self) -> None:
        pass

    def on_epoch_begin(self, epoch: int) -> None:
        pass

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]):
        """Return False to stop training."""


class LearningRateScheduler(Callback):
    """Set the optimizer lr per epoch from ``schedule(epoch) -> lr``.

    A captured train step holds the lr it was captured with (the
    optimizer's update reads it as a host scalar), so a change drops the
    step's CUDA graphs and the next step captures again, once per change
    — schedule at epoch granularity, as the reference does.
    """

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def on_epoch_begin(self, epoch: int) -> None:
        lr = float(self.schedule(epoch))
        opt = self.ffmodel.optimizer
        if hasattr(opt, "alpha"):
            if opt.alpha != lr:
                opt.alpha = lr
                self._recapture()
        elif opt.lr != lr:
            opt.lr = lr
            self._recapture()

    def _recapture(self) -> None:
        graph = getattr(self.ffmodel.compiled, "step_graph", None)
        if graph is not None:
            graph.release()


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "loss", min_delta: float = 0.0,
                 patience: int = 0, mode: str = "auto"):
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.best: Optional[float] = None
        self.wait = 0

    def _improved(self, value: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return value < self.best - self.min_delta
        return value > self.best + self.min_delta

    def on_train_begin(self) -> None:
        self.best, self.wait = None, 0

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]):
        value = logs.get(self.monitor)
        if value is None:
            return
        if self._improved(value):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                return False


class VerifyMetrics(Callback):
    """Assert the final metric clears a threshold
    (reference: keras/callbacks.py VerifyMetrics used by accuracy tests)."""

    def __init__(self, metric: str = "accuracy", threshold: float = 0.9):
        self.metric = metric
        self.threshold = threshold
        self._last: Optional[float] = None

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]):
        self._last = logs.get(self.metric)

    def on_train_end(self) -> None:
        assert self._last is not None, f"metric {self.metric!r} never reported"
        assert self._last >= self.threshold, (
            f"{self.metric}={self._last:.4f} below threshold {self.threshold}")


class EpochVerifyMetrics(Callback):
    """Assert the metric clears the threshold by/at every epoch end once
    reached (reference: keras/callbacks.py EpochVerifyMetrics)."""

    def __init__(self, metric: str = "accuracy", threshold: float = 0.9,
                 from_epoch: int = 0):
        self.metric = metric
        self.threshold = threshold
        self.from_epoch = from_epoch

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]):
        if epoch >= self.from_epoch:
            value = logs.get(self.metric)
            assert value is not None and value >= self.threshold, (
                f"epoch {epoch}: {self.metric}={value} < {self.threshold}")


class ModelCheckpoint(Callback):
    """Snapshot the full training state each ``every`` epochs
    (params, optimizer state, rng counter — runtime/checkpoint.py, the
    npz and manifest format the JAX package reads and writes).
    Beyond the reference, whose keras callbacks only verify metrics;
    restore with ``CheckpointManager(directory).restore(ffmodel)`` or
    ``fit(checkpoint_dir=..., resume=True)``.  Works under both
    keras ``Model.fit`` and ``FFModel.fit``; the final epoch (or the
    epoch early stopping halts on) is always snapshotted even when it
    falls between ``every`` marks."""

    def __init__(self, directory: str, every: int = 1, max_to_keep: int = 3):
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

        self.every = max(1, every)
        self.manager = CheckpointManager(directory, max_to_keep=max_to_keep)
        self._last_seen: Optional[int] = None
        self._last_saved: Optional[int] = None

    def on_train_begin(self) -> None:
        # a reused callback must not mistake a PREVIOUS run's final save
        # for this run's (the stale-state skip would drop the new run's
        # final snapshot)
        self._last_seen = None
        self._last_saved = None

    def on_epoch_end(self, epoch: int, logs: Dict[str, float]):
        self._last_seen = epoch
        if (epoch + 1) % self.every == 0:
            self.manager.save(epoch, self.ffmodel)
            self._last_saved = epoch

    def on_train_end(self) -> None:
        if self._last_seen is not None and self._last_saved != self._last_seen:
            self.manager.save(self._last_seen, self.ffmodel)
            self._last_saved = self._last_seen
