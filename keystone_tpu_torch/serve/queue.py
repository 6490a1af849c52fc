"""The completion handle of one served request — ``ServeFuture`` from
``keystone_tpu/serve/queue.py``. The micro-batcher comes with the HTTP
serving slice."""

from __future__ import annotations

import threading
from typing import Any


class ServeFuture:
    """Completion handle for one submitted request (threading.Event
    based: a server's handler threads block on it)."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._result: Any = None
        self._exc: BaseException | None = None

    def set_result(self, value: Any) -> None:
        self._result = value
        self._done.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: float | None = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError("serve request still pending")
        if self._exc is not None:
            raise self._exc
        return self._result
