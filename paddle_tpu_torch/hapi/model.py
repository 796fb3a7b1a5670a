"""paddle.Model high-level API (reference: python/paddle/hapi/model.py)."""
from __future__ import annotations

import math
import os
import time

import numpy as np

from ..core.tensor import Tensor
from ..core.dispatch import unwrap
from ..nn.layer.layers import Layer
from ..io import DataLoader, Dataset
from ..metric import _host


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs if inputs is None or isinstance(
            inputs, (list, tuple)) else [inputs]
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None, amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics else [])
        return self

    def _loss_value(self, outputs, labels):
        loss = self._loss(outputs, labels)
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*ins)
        loss = self._loss_value(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = []
        for m in self._metrics:
            m.update(unwrap(m.compute(outputs, labels)))
            metrics.append(m.accumulate())
        return ([float(loss.item())], metrics) if metrics else [float(loss.item())]

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        outputs = self.network(*ins)
        loss = self._loss_value(outputs, labels)
        metrics = []
        for m in self._metrics:
            m.update(unwrap(m.compute(outputs, labels)))
            metrics.append(m.accumulate())
        return ([float(loss.item())], metrics) if metrics else [float(loss.item())]

    def predict_batch(self, inputs):
        self.network.eval()
        ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        out = self.network(*ins)
        # a host copy, from the card too (bfloat16 as float32)
        return [_host(out)]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        loader = train_data if isinstance(train_data, DataLoader) else DataLoader(
            train_data, batch_size=batch_size, shuffle=shuffle, drop_last=drop_last,
            num_workers=num_workers)
        from .callbacks import CallbackList
        cbks = CallbackList(callbacks, model=self,
                            params={"epochs": epochs, "verbose": verbose})
        history = []
        it = 0
        cbks.on_train_begin()
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            epoch_losses = []
            t0 = time.perf_counter()
            for step, batch in enumerate(loader):
                data, label = (batch[0], batch[1]) if isinstance(batch, (list, tuple)) \
                    and len(batch) >= 2 else (batch, None)
                cbks.on_train_batch_begin(step)
                out = self.train_batch(data, label)
                loss = out[0] if isinstance(out, tuple) else out
                epoch_losses.append(loss[0])
                it += 1
                cbks.on_train_batch_end(step, {"loss": float(loss[0])})
                if verbose and step % log_freq == 0:
                    print(f"Epoch {epoch + 1}/{epochs} step {step} "  # graftlint: disable=no-adhoc-telemetry
                          f"loss {loss[0]:.4f}")
                if num_iters is not None and it >= num_iters:
                    break
            history.append(float(np.mean(epoch_losses)))
            cbks.on_epoch_end(epoch, {"loss": history[-1]})
            if verbose:
                print(f"Epoch {epoch + 1}: mean loss {history[-1]:.4f} "  # graftlint: disable=no-adhoc-telemetry
                      f"({time.perf_counter() - t0:.1f}s)")
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size, verbose=verbose)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, f"epoch_{epoch}"))
            if num_iters is not None and it >= num_iters:
                break
            if cbks.stop_training:
                self.stop_training = True
                break
        cbks.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else DataLoader(
            eval_data, batch_size=batch_size, num_workers=num_workers)
        losses = []
        for m in self._metrics:
            m.reset()
        for batch in loader:
            data, label = (batch[0], batch[1]) if isinstance(batch, (list, tuple)) \
                and len(batch) >= 2 else (batch, None)
            out = self.eval_batch(data, label)
            loss = out[0] if isinstance(out, tuple) else out
            losses.append(loss[0])
        result = {"loss": [float(np.mean(losses))]}
        for m in self._metrics:
            result[m.name() if isinstance(m.name(), str) else m.name()[0]] = m.accumulate()
        if verbose:
            print("Eval:", result)  # graftlint: disable=no-adhoc-telemetry
        return result

    def predict(self, test_data, batch_size=1, num_workers=0, stack_outputs=False,
                callbacks=None, verbose=1):
        loader = test_data if isinstance(test_data, DataLoader) else DataLoader(
            test_data, batch_size=batch_size, num_workers=num_workers)
        outs = []
        for batch in loader:
            data = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(self.predict_batch(data)[0])
        if stack_outputs:
            return [np.concatenate(outs, axis=0)]
        return [outs]

    def save(self, path, training=True):
        """training=True: params(+opt) checkpoint; training=False: inference
        export via jit.save (StableHLO) using the Model's input specs
        (reference: hapi/model.py Model.save -> _save_inference_model)."""
        from ..framework.io import save as psave
        if training:
            psave(self.network.state_dict(), path + ".pdparams")
            if self._optimizer is not None:
                psave(self._optimizer.state_dict(), path + ".pdopt")
        else:
            if self._inputs is None:
                raise ValueError(
                    "Model.save(training=False) needs input specs: "
                    "Model(net, inputs=[InputSpec(...)])")
            from .. import jit
            jit.save(self.network, path, input_spec=list(self._inputs))

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load as pload
        self.network.set_state_dict(pload(path + ".pdparams"))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(pload(path + ".pdopt"))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        return summary(self.network, input_size, dtype)


def summary(net, input_size=None, dtypes=None, input=None):
    """reference: python/paddle/hapi/model_summary.py."""
    rows = []
    total_params = 0
    trainable_params = 0
    for name, p in net.named_parameters():
        n = p.size
        total_params += n
        if not p.stop_gradient:
            trainable_params += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<20}{'Param #':<12}",
             "-" * (width + 32)]
    for name, shape, n in rows:
        lines.append(f"{name:<{width}}{str(shape):<20}{n:<12,}")
    lines.append("-" * (width + 32))
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    out = "\n".join(lines)
    print(out)  # graftlint: disable=no-adhoc-telemetry (summary() prints by contract)
    return {"total_params": total_params, "trainable_params": trainable_params}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Rough analytic FLOPs for Linear/Conv layers (reference: hapi/dynamic_flops.py)."""
    from ..nn.layer.common import Linear
    from ..nn.layer.conv import _ConvNd
    total = 0
    for layer in net.sublayers(include_self=True):
        if isinstance(layer, Linear):
            total += 2 * layer._in_features * layer._out_features
        elif isinstance(layer, _ConvNd):
            import numpy as _np
            k = _np.prod(layer._kernel_size)
            total += 2 * layer._in_channels * layer._out_channels * k
    if print_detail:
        print(f"FLOPs (per spatial position / token): {total:,}")  # graftlint: disable=no-adhoc-telemetry
    return total
