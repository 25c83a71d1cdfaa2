"""Micro-batching inference server.

Counterpart of `petr_tpu/serve/server.py`: one dispatcher thread packs
queued single-sample requests into fixed-size batches (a partial batch is
padded by tiling its first sample and the padding's outputs are dropped),
runs the serving step and resolves per-request futures with numpy results.
Transport-agnostic: wrap ``submit`` in whatever RPC layer the deployment
uses.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, Mapping

import numpy as np


class InferenceServer:
    """Batches ``submit()``-ed samples through a serving callable.

    Args:
        serving_fn: callable ``fn(*inputs)`` over batched positional numpy
            inputs in ``input_keys`` order returning a dict of numpy arrays
            with a leading batch axis, e.g. ``make_serving_fn(cfg, model)``.
        batch_size: the batch every call is padded to.
        input_keys: positional order of per-sample input arrays
            (``serving_input_spec(cfg)``'s keys; a PETRv2 config adds
            ``timestamp``, batched and padded like the others).
        max_delay_ms: how long the dispatcher waits to fill a batch before
            dispatching a padded partial one.
    """

    def __init__(
        self,
        serving_fn: Callable[..., Dict[str, np.ndarray]],
        *,
        batch_size: int = 1,
        input_keys=("images", "img2lidar", "img_hw"),
        max_delay_ms: float = 5.0,
    ):
        self._fn = serving_fn
        self._batch = batch_size
        self._keys = tuple(input_keys)
        self._delay = max_delay_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, sample: Mapping[str, np.ndarray]) -> "Future[Dict[str, np.ndarray]]":
        """Enqueue one sample (unbatched arrays keyed by ``input_keys``);
        resolves to the decoded dict (boxes/scores/labels/valid)."""
        if self._closed:
            raise RuntimeError("server is closed")
        missing = [k for k in self._keys if k not in sample]
        if missing:
            raise KeyError(f"sample missing inputs: {missing}")
        fut: "Future[Dict[str, np.ndarray]]" = Future()
        self._q.put((sample, fut))
        return fut

    def close(self) -> None:
        self._closed = True
        self._q.put(None)
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher ---------------------------------------------------------

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            pending = [item]
            deadline = time.monotonic() + self._delay
            while len(pending) < self._batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(pending)
                    return
                pending.append(nxt)
            self._dispatch(pending)

    def _dispatch(self, pending) -> None:
        samples = [s for s, _ in pending]
        futures = [f for _, f in pending]
        n = len(samples)
        try:
            inputs = []
            for k in self._keys:
                arr = np.stack([np.asarray(s[k]) for s in samples])
                if n < self._batch:  # pad by tiling the first sample
                    pad = np.broadcast_to(arr[:1], (self._batch - n,) + arr.shape[1:])
                    arr = np.concatenate([arr, pad], axis=0)
                inputs.append(arr)
            out: Dict[str, Any] = self._fn(*inputs)
            for i, fut in enumerate(futures):
                fut.set_result({k: np.asarray(v)[i] for k, v in out.items()})
        except Exception as e:  # resolve every future; the server stays up
            for fut in futures:
                if not fut.done():
                    fut.set_exception(e)
