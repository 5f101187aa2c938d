"""ResponseHandler — decouples token generation from response delivery.

Equivalent of the reference's ResponseHandler
(reference: src/scheduler/response_handler.{h,cpp}): streams delta outputs,
finalizes finished requests, and honors cancel-on-disconnect (callback
returning False cancels the request, response_handler.cpp:90-93). Delivery
runs on a single background thread so detokenization and user callbacks never
block the scheduler loop (reference uses a 1-thread pool likewise).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from scalellm_tpu_torch.request.output import RequestOutput, Status, StatusCode, Usage
from scalellm_tpu_torch.request.request import Request

logger = logging.getLogger(__name__)

_SHUTDOWN = object()


class ResponseHandler:
    def __init__(self, tokenizer, threaded: bool = True):
        self._tokenizer = tokenizer
        self._threaded = threaded
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        if threaded:
            self._thread = threading.Thread(
                target=self._worker, name="response-handler", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------- dispatch

    def on_request_stream(self, request: Request) -> None:
        """Stream newly-decoded deltas (reference: response_handler.cpp:47)."""
        self._submit(self._do_stream, request)

    def on_request_finish(self, request: Request) -> None:
        """Finalize a finished request (reference: response_handler.cpp:34)."""
        self._submit(self._do_finish, request)

    def on_request_error(self, request: Request, status: Status) -> None:
        def deliver():
            request.on_output(
                RequestOutput(
                    request_id=request.id,
                    prompt=request.prompt,
                    status=status,
                    finished=True,
                )
            )

        self._submit(lambda _r: deliver(), request)

    def _submit(self, fn, request) -> None:
        if self._threaded:
            self._queue.put((fn, request))
        else:
            fn(request)

    def wait_for_complete(self) -> None:
        """Drain pending deliveries (reference: response_handler.cpp:97)."""
        if self._threaded:
            self._queue.join()

    def shutdown(self) -> None:
        if self._threaded and self._thread is not None:
            self._queue.put(_SHUTDOWN)
            self._thread.join(timeout=5)
            self._thread = None

    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is _SHUTDOWN:
                    return
                fn, request = item
                fn(request)
            except Exception:
                logger.exception("response delivery failed")
            finally:
                self._queue.task_done()

    # ------------------------------------------------------------- delivery

    def _do_stream(self, request: Request) -> None:
        outputs = []
        for seq in request.sequences:
            delta = seq.build_delta_output(self._tokenizer)
            if delta is not None and delta.text:
                # The finish reason goes out once, in _do_finish's terminal
                # chunk: the scheduler may finish the sequence between this
                # job's queueing and its run, and the reference's copy then
                # sends it in both chunks.
                delta.finish_reason = None
                outputs.append(delta)
        if not outputs:
            return
        ok = request.on_output(
            RequestOutput(
                request_id=request.id,
                prompt=request.prompt,
                status=Status(StatusCode.OK),
                outputs=outputs,
                finished=False,
            )
        )
        if ok is False:
            request.cancel()

    def _do_finish(self, request: Request) -> None:
        if request.is_cancelled:
            request.on_output(
                RequestOutput(
                    request_id=request.id,
                    prompt=request.prompt,
                    status=Status(StatusCode.CANCELLED),
                    usage=request.build_usage(),
                    finished=True,
                )
            )
            return
        if request.stream:
            # Deltas were already streamed; send the terminal chunk.
            outputs = []
            for seq in request.sequences:
                delta = seq.build_delta_output(self._tokenizer)
                if delta is not None:
                    outputs.append(delta)
            request.on_output(
                RequestOutput(
                    request_id=request.id,
                    prompt=request.prompt,
                    status=Status(StatusCode.OK),
                    outputs=outputs,
                    usage=request.build_usage(),
                    finished=True,
                )
            )
        else:
            request.on_output(request.build_output(self._tokenizer))
