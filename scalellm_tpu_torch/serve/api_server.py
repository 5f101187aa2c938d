"""OpenAI-compatible API server on the port's AsyncLLMEngine
(counterpart of scalellm_tpu/serve/api_server.py).

Routes: /health, /metrics (Prometheus text), /config (the handler's
options, the effective model args and the overrides applied),
/profile/start and /profile/stop (a torch.profiler trace, CPU and, on a
CUDA device, CUDA activities, written under the request's log_dir when
profiling stops), /v1/models (the model and its LoRA adapters),
/v1/completions and /v1/chat/completions (both with SSE streaming), served
by the asyncio HttpServer of serve/http.py. It imports no grpc.

Run: python -m scalellm_tpu_torch.serve.api_server --model <path> --port 8080
(--devices auto, the default, serves on the card; --devices cpu on the
CPU). Options that ask for parallelism (--tp-size above 1,
--sequence-parallel, --coordinator) are refused by
LLMHandlerOptions.check_ported before the model loads. SIGINT and SIGTERM
stop the loop; engine.stop() then gives the device memory back.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import os
import signal
import tempfile
import time
from typing import Optional

from scalellm_tpu_torch.errors import ValidationError
from scalellm_tpu_torch.llm_engine import AsyncLLMEngine
from scalellm_tpu_torch.serve.api_protocol import (
    ChatCompletionRequest,
    CompletionRequest,
    error_json,
    now,
    status_to_http,
)
from scalellm_tpu_torch.serve.chat_handler import (
    generate_chat_response,
    generate_chat_stream,
)
from scalellm_tpu_torch.serve.completion_handler import (
    generate_completion_response,
    generate_completion_stream,
)
from scalellm_tpu_torch.serve.http import HttpServer, Request, Response, SSEResponse
from scalellm_tpu_torch.utils.metrics import export_prometheus

logger = logging.getLogger(__name__)

DEFAULT_PROFILE_DIR = os.path.join(tempfile.gettempdir(), "scalellm_tpu_torch_profile")


class ApiServer:
    def __init__(self, engine: AsyncLLMEngine, model_name: str):
        self.engine = engine
        self.model_name = model_name
        # LoRA adapters served alongside the base model; requests select
        # one with the OpenAI `model` field.
        self.lora_names = set(getattr(engine, "lora_names", []) or [])
        self.http = HttpServer()
        # The running torch.profiler trace and its directory (/profile/*).
        self._profile = None
        self._register()

    def _lora_of(self, body) -> "str | None":
        return body.model if body.model in self.lora_names else None

    def _register(self):
        http = self.http

        @http.route("GET", "/health")
        async def health(req: Request):
            return Response.text("OK")

        @http.route("GET", "/metrics")
        async def metrics(req: Request):
            return Response.text(export_prometheus(), content_type="text/plain; version=0.0.4")

        @http.route("GET", "/config")
        async def config(req: Request):
            """The handler's options, the effective model args and the
            --model-args-override list applied."""
            opts = dataclasses.asdict(self.engine._handler.options)
            eng = getattr(self.engine._handler, "engine", None)
            if eng is not None and hasattr(eng, "model_args"):
                ma = dataclasses.asdict(eng.model_args)
                ma.pop("raw", None)
                opts["model_args"] = ma
                opts["model_args_overrides_applied"] = getattr(
                    eng, "applied_model_args_overrides", []
                )
            return Response.json(opts)

        @http.route("POST", "/profile/start")
        async def profile_start(req: Request):
            """Start a torch.profiler trace of the process (the scheduler
            loop's steps included): CPU activity, and CUDA's where the
            engine serves on a CUDA device."""
            from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

            if self._profile is not None:
                raise RuntimeError("a profiler trace is already running")
            body = req.json() if req.body else {}
            log_dir = body.get("log_dir", DEFAULT_PROFILE_DIR)
            activities = [ProfilerActivity.CPU]
            if self.engine._handler.options.device().startswith("cuda"):
                activities.append(ProfilerActivity.CUDA)
            # Every thread: the engine steps on the scheduler loop's thread,
            # not this event loop's.
            prof = profile(activities=activities,
                           experimental_config=_ExperimentalConfig(profile_all_threads=True))
            prof.start()
            self._profile = (prof, log_dir)
            return Response.json({"status": "tracing", "log_dir": log_dir})

        @http.route("POST", "/profile/stop")
        async def profile_stop(req: Request):
            """Stop the trace and write it as a Chrome trace under its
            log_dir; the response names the file."""
            if self._profile is None:
                raise RuntimeError("no profiler trace is running")
            prof, log_dir = self._profile
            self._profile = None
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            return Response.json({"status": "stopped", "trace": path})

        @http.route("GET", "/v1/models")
        async def models(req: Request):
            return Response.json(
                {
                    "object": "list",
                    "data": [
                        {
                            "id": name,
                            "object": "model",
                            "created": now(),
                            "owned_by": "scalellm_tpu",
                        }
                        for name in [self.model_name, *sorted(self.lora_names)]
                    ],
                }
            )

        @http.route("POST", "/v1/completions")
        async def completions(req: Request):
            try:
                body = CompletionRequest.from_json(req.json())
            except ValidationError as e:
                return Response.json(error_json(e.message), status_to_http(e.code))
            except Exception as e:
                return Response.json(error_json(f"invalid JSON: {e}"), 400)
            try:
                if body.stream:
                    sse = SSEResponse()
                    asyncio.get_running_loop().create_task(
                        generate_completion_stream(
                            self.engine, body, self.model_name, sse,
                            lora=self._lora_of(body),
                        )
                    )
                    return sse
                return await generate_completion_response(
                    self.engine, body, self.model_name,
                    lora=self._lora_of(body),
                )
            except ValidationError as e:
                return Response.json(error_json(e.message), status_to_http(e.code))

        @http.route("POST", "/v1/chat/completions")
        async def chat(req: Request):
            try:
                body = ChatCompletionRequest.from_json(req.json())
            except ValidationError as e:
                return Response.json(error_json(e.message), status_to_http(e.code))
            except Exception as e:
                return Response.json(error_json(f"invalid JSON: {e}"), 400)
            try:
                if body.stream:
                    sse = SSEResponse()
                    asyncio.get_running_loop().create_task(
                        generate_chat_stream(
                            self.engine, body, self.model_name, sse,
                            lora=self._lora_of(body),
                        )
                    )
                    return sse
                return await generate_chat_response(
                    self.engine, body, self.model_name,
                    lora=self._lora_of(body),
                )
            except ValidationError as e:
                return Response.json(error_json(e.message), status_to_http(e.code))

    async def run(self, host: str, port: int):
        self.engine.start()
        await self.http.start(host, port)
        logger.info("listening on %s:%d", host, port)
        await self.http.serve_forever()


def build_arg_parser() -> argparse.ArgumentParser:
    """The reference's flags and defaults, and --devices."""
    p = argparse.ArgumentParser(description="scalellm_tpu_torch OpenAI-compatible server")
    p.add_argument("--model", type=str, required=True, help="model folder path")
    p.add_argument("--served-model-name", "--model-id", dest="model_id", type=str, default=None)
    p.add_argument("--devices", type=str, default="auto",
                   help='"auto" (the card), "cuda", "cuda:N" or "cpu"')
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--max-cache-size", type=int, default=0)
    p.add_argument("--max-memory-utilization", type=float, default=0.9)
    p.add_argument("--enable-prefix-cache", action="store_true", default=True)
    p.add_argument("--disable-prefix-cache", dest="enable_prefix_cache", action="store_false")
    p.add_argument("--enable-cuda-graph", action="store_true", default=True,
                   help="one CUDA graph per step bucket, captured at warmup")
    p.add_argument("--disable-warmup", dest="enable_cuda_graph", action="store_false")
    p.add_argument("--max-tokens-per-batch", type=int, default=512)
    p.add_argument("--num-decode-steps", type=int, default=1,
                   help="decode micro-steps per dispatch (multi-step decode)")
    p.add_argument("--disable-async-scheduling", dest="enable_async_scheduling",
                   action="store_false", default=True,
                   help="disable pipelined (one step in flight) scheduling")
    p.add_argument("--lora-modules", nargs="+", default=None,
                   metavar="NAME=PATH",
                   help="LoRA adapters served alongside the base model; "
                   "requests select one via the OpenAI `model` field")
    p.add_argument("--max-seqs-per-batch", type=int, default=128)
    p.add_argument("--num-speculative-tokens", type=int, default=0)
    p.add_argument("--draft-model", type=str, default=None)
    p.add_argument("--num-handling-threads", type=int, default=4)
    p.add_argument("--tp-size", type=int, default=1)
    p.add_argument("--sequence-parallel", action="store_true", default=False,
                   help="sequence parallelism over the tp axis (not ported: refused)")
    p.add_argument("--num-blocks", type=int, default=0)
    p.add_argument("--kv-cache-dtype", type=str, default="auto", choices=["auto", "int8"])
    p.add_argument("--quantize", type=str, default="", choices=["", "int4", "int8"],
                   help="runtime weight quantization of dense checkpoints")
    p.add_argument("--warmup-mode", type=str, default="full", choices=["off", "fast", "full"],
                   help="full (default) = capture the step graph of every reachable "
                        "bucket at init (no capture while serving)")
    p.add_argument("--model-args-override", action="append", default=[],
                   metavar="FIELD=VALUE",
                   help="override a loaded ModelArgs field (dotted paths "
                   "reach QuantArgs: quant_args.bits=8); repeatable; shown at /config")
    # Multi-host serving: not ported, so a coordinator is refused.
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host coordinator address host:port (not ported: refused)")
    p.add_argument("--num-hosts", type=int, default=None)
    p.add_argument("--host-id", type=int, default=None)
    return p


def engine_from_args(args: argparse.Namespace) -> AsyncLLMEngine:
    """The AsyncLLMEngine that the flags `args` ask for."""
    return AsyncLLMEngine(
        model=args.model,
        devices=args.devices,
        block_size=args.block_size,
        max_cache_size=args.max_cache_size,
        max_memory_utilization=args.max_memory_utilization,
        enable_prefix_cache=args.enable_prefix_cache,
        enable_cuda_graph=args.enable_cuda_graph,
        max_tokens_per_batch=args.max_tokens_per_batch,
        max_seqs_per_batch=args.max_seqs_per_batch,
        num_speculative_tokens=args.num_speculative_tokens,
        draft_model=args.draft_model,
        num_handling_threads=args.num_handling_threads,
        tp_size=args.tp_size,
        sequence_parallel=args.sequence_parallel,
        num_blocks=args.num_blocks,
        kv_cache_dtype=args.kv_cache_dtype,
        quantize=args.quantize,
        warmup_mode=args.warmup_mode,
        model_args_overrides=args.model_args_override,
        distributed=bool(args.coordinator),
        enable_async_scheduling=args.enable_async_scheduling,
        num_decode_steps=args.num_decode_steps,
        lora_modules=dict(m.split("=", 1) for m in args.lora_modules)
        if args.lora_modules else None,
    )


def served_model_name(args: argparse.Namespace) -> str:
    return args.model_id or args.model.rstrip("/").split("/")[-1]


def main(argv: Optional[list] = None):
    logging.basicConfig(level=logging.INFO)
    args = build_arg_parser().parse_args(argv)
    engine = engine_from_args(args)
    server = ApiServer(engine, served_model_name(args))

    loop = asyncio.new_event_loop()
    signalled = []

    def stop(sig):
        signalled.append(sig)
        loop.stop()

    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop, sig)
    try:
        loop.run_until_complete(server.run(args.host, args.port))
    except RuntimeError:
        # loop.stop() ends run_until_complete with "Event loop stopped
        # before Future completed"; any other RuntimeError is a fault.
        if not signalled:
            raise
    finally:
        engine.stop()
        loop.close()


if __name__ == "__main__":
    main()
