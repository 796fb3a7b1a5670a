"""hapi training callbacks (reference: python/paddle/hapi/callbacks.py —
Callback/CallbackList, ProgBarLogger:226, ModelCheckpoint:481,
LRScheduler:539, EarlyStopping:598, VisualDL:713)."""
from __future__ import annotations

import os
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "CallbackList"]


class Callback:
    """reference: callbacks.py Callback — all hooks are no-ops by default."""

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model=None, params=None):
        self.callbacks = list(callbacks or [])
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, hook, *args):
        for c in self.callbacks:
            getattr(c, hook)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)

    @property
    def stop_training(self):
        return any(getattr(c, "stop_training", False)
                   for c in self.callbacks)


class ProgBarLogger(Callback):
    """reference: callbacks.py:226 — periodic loss/metric lines."""

    def __init__(self, log_freq=1, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            items = " ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                             f"{k}: {v}" for k, v in logs.items())
            print(f"Epoch {self._epoch + 1} step {step} {items}")  # graftlint: disable=no-adhoc-telemetry

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            logs = logs or {}
            items = " ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                             f"{k}: {v}" for k, v in logs.items())
            print(f"Epoch {epoch + 1} done "  # graftlint: disable=no-adhoc-telemetry
                  f"({time.perf_counter() - self._t0:.1f}s) {items}")


class ModelCheckpoint(Callback):
    """reference: callbacks.py:481 — save every N epochs."""

    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, f"{epoch}")
            self.model.save(path)


class LRScheduler(Callback):
    """reference: callbacks.py:539 — step the lr scheduler per epoch/batch."""

    def __init__(self, by_step=False, by_epoch=True):
        self.by_step, self.by_epoch = by_step, by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class EarlyStopping(Callback):
    """reference: callbacks.py:598 — stop when a monitored metric stalls."""

    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True,
                 save_dir=None):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.verbose = verbose
        self.save_best_model = save_best_model
        self.save_dir = save_dir
        self._maximize = mode == "max" or (mode == "auto" and "acc" in
                                           monitor)
        self._reset()

    def _cmp(self, cur, best):
        return cur > best + self.min_delta if self._maximize else \
            cur < best - self.min_delta

    def _reset(self):
        self.best = -np.inf if self._maximize else np.inf
        if self.baseline is not None:
            self.best = self.baseline
        self.stop_training = False
        self.wait = 0

    def on_train_begin(self, logs=None):
        # a reused instance must not inherit the previous fit()'s state
        self._reset()

    def on_epoch_end(self, epoch, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple, np.ndarray))
                    else cur)
        if self._cmp(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.save_dir:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: stop at epoch {epoch + 1} "  # graftlint: disable=no-adhoc-telemetry
                          f"({self.monitor}={cur:.4f} best={self.best:.4f})")
