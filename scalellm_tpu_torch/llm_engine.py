"""AsyncLLMEngine and its output streams — the async serving engine
(counterpart of scalellm_tpu/llm_engine.py).

OutputStream (a synchronous iterator) and OutputAsyncStream (an asyncio
iterator fed through call_soon_threadsafe) carry a request's outputs from
the handler's threads to the caller; AsyncLLMEngine schedules requests
(schedule_async / schedule_chat_async, with tool definitions and a LoRA
adapter by name) onto an LLMHandler whose scheduler loop runs on its own
thread between start() and stop(). A not-ok status raises ValidationError
from the iterator; after cancel() a stream's put returns False, and the
scheduler retires the request.

The engine takes the port's LLM options (devices "auto" is the card,
quantize_lm_head, host_swap_bytes, lora_modules). Unlike the reference's,
stop() also drops the engine and gives its device memory back, as
LLM.close does: a process that builds a second engine needs the memory.
tp_size > 1 serves over that many ranks, as LLM does (engine/distributed.py;
stop() stops the other ranks), and distributed=True on a world the caller
has joined. The reference's `mesh` argument (a jax Mesh) has no counterpart:
the ranks are processes, so a mesh raises NotImplementedError that names
tp_size and devices instead.
"""

from __future__ import annotations

import asyncio
import queue
from typing import List, Optional, Sequence

from scalellm_tpu_torch.errors import ValidationError
from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions
from scalellm_tpu_torch.request.output import Priority, RequestOutput
from scalellm_tpu_torch.sampling.params import SamplingParams
from scalellm_tpu_torch.utils.chat import Message


class OutputStream:
    """Synchronous stream of RequestOutputs."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._cancelled = False

    def put(self, item: RequestOutput) -> bool:
        if self._cancelled:
            return False
        if item.status is not None and not item.status.ok:
            self._queue.put(ValidationError(item.status.code, item.status.message))
            return False
        self._queue.put(item)
        if item.finished:
            self._queue.put(None)  # sentinel
        return True

    def cancel(self) -> None:
        self._cancelled = True
        self._queue.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> RequestOutput:
        item = self._queue.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item


class OutputAsyncStream:
    """Asyncio stream of RequestOutputs; put is called from the handler's
    threads."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._queue: asyncio.Queue = asyncio.Queue()
        self._cancelled = False

    def put(self, item: RequestOutput) -> bool:
        if self._cancelled:
            return False
        if item.status is not None and not item.status.ok:
            err = ValidationError(item.status.code, item.status.message)
            self._loop.call_soon_threadsafe(self._queue.put_nowait, err)
            return False
        self._loop.call_soon_threadsafe(self._queue.put_nowait, item)
        if item.finished:
            self._loop.call_soon_threadsafe(self._queue.put_nowait, None)
        return True

    def cancel(self) -> None:
        self._cancelled = True
        self._loop.call_soon_threadsafe(self._queue.put_nowait, None)

    def __aiter__(self):
        return self

    async def __anext__(self) -> RequestOutput:
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        if isinstance(item, Exception):
            raise item
        return item


class AsyncLLMEngine:
    def __init__(
        self,
        model: str,
        devices: str = "auto",
        block_size: int = 16,
        max_cache_size: int = 0,
        max_memory_utilization: float = 0.9,
        enable_prefix_cache: bool = True,
        enable_cuda_graph: bool = True,
        max_tokens_per_batch: int = 512,
        max_seqs_per_batch: int = 128,
        num_speculative_tokens: int = 0,
        num_handling_threads: int = 4,
        draft_model: Optional[str] = None,
        tp_size: int = 1,
        sequence_parallel: bool = False,
        num_blocks: int = 0,
        kv_cache_dtype: str = "auto",
        quantize: str = "",
        quantize_lm_head: "bool | str" = False,
        host_swap_bytes: int = 0,
        warmup_mode: str = "fast",
        model_args_overrides=None,
        distributed: bool = False,
        enable_async_scheduling: bool = True,
        num_decode_steps: int = 1,
        lora_modules=None,
        mesh=None,
    ) -> None:
        if mesh is not None:
            raise NotImplementedError("a mesh is not taken: tensor parallelism runs one process a rank; pass "
                                      "tp_size and devices (engine/distributed.py)")
        options = LLMHandlerOptions(
            model_path=model,
            devices=devices,
            draft_model_path=draft_model,
            block_size=block_size,
            max_cache_size=max_cache_size,
            max_memory_utilization=max_memory_utilization,
            enable_prefix_cache=enable_prefix_cache,
            enable_cuda_graph=enable_cuda_graph,
            max_tokens_per_batch=max_tokens_per_batch,
            max_seqs_per_batch=max_seqs_per_batch,
            num_speculative_tokens=num_speculative_tokens,
            num_handling_threads=num_handling_threads,
            tp_size=tp_size,
            sequence_parallel=sequence_parallel,
            num_blocks=num_blocks,
            kv_cache_dtype=kv_cache_dtype,
            quantize=quantize,
            quantize_lm_head=quantize_lm_head,
            host_swap_bytes=host_swap_bytes,
            warmup_mode=warmup_mode,
            model_args_overrides=model_args_overrides,
            distributed=distributed,
            enable_async_scheduling=enable_async_scheduling,
            num_decode_steps=num_decode_steps,
            lora_modules=lora_modules,
        )
        self._handler: Optional[LLMHandler] = LLMHandler(options)

    # ------------------------------------------------------------- scheduling

    async def schedule_async(
        self,
        prompt: str,
        sampling_params: Optional[SamplingParams] = None,
        priority: Priority = Priority.NORMAL,
        stream: bool = False,
        lora: Optional[str] = None,
    ) -> OutputAsyncStream:
        sp = sampling_params or SamplingParams()
        out_stream = OutputAsyncStream(asyncio.get_running_loop())
        self._handler.schedule_async(prompt, sp, priority, stream, out_stream.put, lora=lora)
        return out_stream

    @property
    def lora_names(self) -> List[str]:
        meta = getattr(self._handler.engine, "lora_meta", None)
        return list(meta.names) if meta is not None else []

    async def schedule_chat_async(
        self,
        messages: Sequence[Message],
        sampling_params: Optional[SamplingParams] = None,
        priority: Priority = Priority.NORMAL,
        stream: bool = False,
        tools=None,
        lora: Optional[str] = None,
    ) -> OutputAsyncStream:
        sp = sampling_params or SamplingParams()
        out_stream = OutputAsyncStream(asyncio.get_running_loop())
        self._handler.schedule_chat_async(messages, sp, priority, stream, out_stream.put, tools=tools, lora=lora)
        return out_stream

    def schedule(
        self,
        prompt: str,
        sampling_params: Optional[SamplingParams] = None,
        priority: Priority = Priority.NORMAL,
        stream: bool = False,
    ) -> OutputStream:
        sp = sampling_params or SamplingParams()
        out_stream = OutputStream()
        self._handler.schedule_async(prompt, sp, priority, stream, out_stream.put)
        return out_stream

    def schedule_chat(
        self,
        messages: Sequence[Message],
        sampling_params: Optional[SamplingParams] = None,
        priority: Priority = Priority.NORMAL,
        stream: bool = False,
        tools=None,
    ) -> OutputStream:
        sp = sampling_params or SamplingParams()
        out_stream = OutputStream()
        self._handler.schedule_chat_async(messages, sp, priority, stream, out_stream.put, tools=tools)
        return out_stream

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._handler.start()

    def stop(self) -> None:
        """Stop the scheduler loop and the handler's threads, drop the
        engine and give its device memory (weights, KV cache, graph pools)
        back to the device, as LLM.close does. The engine serves no more
        after it."""
        if self._handler is None:
            return
        import gc

        import torch

        handler, self._handler = self._handler, None
        handler.stop()
        del handler  # the engine's last reference, before the cache is emptied
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def apply_chat_template(self, messages: Sequence[Message]) -> Optional[str]:
        return self._handler.apply_chat_template(messages)

    def encode(self, text: str) -> List[int]:
        return self._handler.encode(text)

    def decode(self, tokens: Sequence[int]) -> str:
        return self._handler.decode(tokens)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
