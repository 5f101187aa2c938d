"""gRPC server: Completion / Chat / Models services on the port's
LLMHandler (counterpart of scalellm_tpu/serve/grpc_server.py).

grpcio's generic method handlers over the messages of serve/pb (the proto
package scalellm_tpu and its service names, so either package's clients and
gateway talk to it); streaming responses are fed from the handler's
response thread through a per-call queue (_CallQueue), and a client that
disconnects cancels its request.

Run: python -m scalellm_tpu_torch.serve.grpc_server --model <path> --port 8500
(the flags of serve/api_server.py, --devices among them).
"""

from __future__ import annotations

import logging
import queue
import time
import uuid
from concurrent import futures
from typing import Iterator, Optional

import grpc

from scalellm_tpu_torch.handlers.llm_handler import LLMHandler
from scalellm_tpu_torch.request.output import Priority, RequestOutput
from scalellm_tpu_torch.sampling.params import SamplingParams
from scalellm_tpu_torch.serve.pb import llm_pb2
from scalellm_tpu_torch.utils.chat import Message

logger = logging.getLogger(__name__)

_SENTINEL = object()


def _to_sampling_params(pb: llm_pb2.SamplingParams) -> SamplingParams:
    sp = SamplingParams()
    if pb.HasField("max_tokens"):
        sp.max_tokens = pb.max_tokens
    if pb.HasField("n"):
        sp.n = pb.n
    if pb.HasField("best_of"):
        sp.best_of = pb.best_of
    if pb.HasField("echo"):
        sp.echo = pb.echo
    if pb.HasField("frequency_penalty"):
        sp.frequency_penalty = pb.frequency_penalty
    if pb.HasField("presence_penalty"):
        sp.presence_penalty = pb.presence_penalty
    if pb.HasField("repetition_penalty"):
        sp.repetition_penalty = pb.repetition_penalty
    if pb.HasField("temperature"):
        sp.temperature = pb.temperature
    if pb.HasField("top_p"):
        sp.top_p = pb.top_p
    if pb.HasField("top_k"):
        sp.top_k = pb.top_k
    if pb.HasField("logprobs"):
        sp.logprobs = pb.logprobs
    if pb.HasField("top_logprobs"):
        sp.top_logprobs = pb.top_logprobs
    if pb.HasField("skip_special_tokens"):
        sp.skip_special_tokens = pb.skip_special_tokens
    if pb.HasField("ignore_eos"):
        sp.ignore_eos = pb.ignore_eos
    if pb.stop:
        sp.stop = list(pb.stop)
    if pb.stop_token_ids:
        sp.stop_token_ids = list(pb.stop_token_ids)
    if pb.HasField("seed"):
        sp.seed = pb.seed
    if pb.logit_bias:
        sp.logit_bias = {int(k): float(v) for k, v in pb.logit_bias.items()}
    if pb.HasField("guided_regex"):
        sp.guided_regex = pb.guided_regex
    if pb.HasField("guided_json"):
        sp.guided_json = pb.guided_json
    if pb.guided_choice:
        sp.guided_choice = list(pb.guided_choice)
    if sp.best_of is None:
        sp.best_of = sp.n
    return sp


def _logprobs_pb(logprobs):
    out = []
    for lp in logprobs or []:
        pb = llm_pb2.LogProb(token=lp.token, token_id=lp.token_id, logprob=lp.logprob)
        for d in lp.top_logprobs or []:
            pb.top_logprobs.append(
                llm_pb2.LogProbData(token=d.token, token_id=d.token_id, logprob=d.logprob)
            )
        out.append(pb)
    return out


class _CallQueue:
    """Bridges the engine callback thread to the gRPC response iterator
    (the analog of the reference's StreamCallData write queue)."""

    def __init__(self, context: grpc.ServicerContext):
        self._q: "queue.Queue" = queue.Queue()
        self._context = context

    def put(self, out: RequestOutput) -> bool:
        if not self._context.is_active():
            self._q.put(_SENTINEL)
            return False  # client disconnected → cancel request
        self._q.put(out)
        if out.finished:
            self._q.put(_SENTINEL)
        return True

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                return
            yield item


class LLMServicer:
    def __init__(self, handler: LLMHandler, model_name: str):
        self._handler = handler
        self._model = model_name

    # -------------------------------------------------------------- completion

    def _lora_of(self, model_field: str):
        """The OpenAI `model` field selects a LoRA adapter by name."""
        meta = getattr(self._handler.engine, "lora_meta", None)
        if meta is not None and model_field in meta.names:
            return model_field
        return None

    def complete(self, request: llm_pb2.CompletionRequest, context) -> Iterator[llm_pb2.CompletionResponse]:
        sp = _to_sampling_params(request.sampling)
        stream = request.stream
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        cq = _CallQueue(context)
        self._handler.schedule_async(
            request.prompt, sp, Priority(request.priority or 1), stream, cq.put,
            lora=self._lora_of(request.model),
        )
        for out in cq:
            if out.status is not None and not out.status.ok:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, out.status.message)
                return
            resp = llm_pb2.CompletionResponse(
                id=rid, object="text_completion", created=int(time.time()),
                model=self._model,
            )
            for so in out.outputs:
                choice = llm_pb2.CompletionChoice(index=so.index, text=so.text)
                if so.finish_reason is not None:
                    choice.finish_reason = so.finish_reason.to_api_string()
                for lp in _logprobs_pb(so.logprobs):
                    choice.logprobs.append(lp)
                resp.choices.append(choice)
            if out.usage is not None:
                resp.usage.prompt_tokens = out.usage.num_prompt_tokens
                resp.usage.completion_tokens = out.usage.num_generated_tokens
                resp.usage.total_tokens = out.usage.num_total_tokens
            yield resp

    # -------------------------------------------------------------- chat

    def chat(self, request: llm_pb2.ChatRequest, context) -> Iterator[llm_pb2.ChatResponse]:
        import json as _json

        from scalellm_tpu_torch.utils.tools import (
            StreamToolBuffer,
            guided_regex_for_tools,
            parse_tool_calls,
            validate_tool_choice,
            validate_tools,
        )

        sp = _to_sampling_params(request.sampling)
        stream = request.stream
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        tools = None
        tool_choice = "auto"
        try:
            if request.HasField("tools_json"):
                tools = validate_tools(_json.loads(request.tools_json))
            if request.HasField("tool_choice_json"):
                tool_choice = validate_tool_choice(
                    _json.loads(request.tool_choice_json), tools
                )
        except (ValueError, _json.JSONDecodeError) as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return
        tools_active = bool(tools) and tool_choice != "none"
        if tools_active and tool_choice != "auto":
            if sp.guided_regex or sp.guided_json or sp.guided_choice:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    "tool_choice forcing cannot be combined with guided_* params",
                )
                return
            if tool_choice == "required":
                sp.guided_regex = guided_regex_for_tools(tools)
            elif isinstance(tool_choice, dict):
                sp.guided_regex = guided_regex_for_tools(
                    tools, tool_choice["function"]["name"]
                )
        messages = [
            Message(
                m.role,
                m.content,
                tool_calls=_json.loads(m.tool_calls_json)
                if m.HasField("tool_calls_json")
                else None,
                tool_call_id=m.tool_call_id
                if m.HasField("tool_call_id")
                else None,
            )
            for m in request.messages
        ]
        cq = _CallQueue(context)
        self._handler.schedule_chat_async(
            messages, sp, Priority(request.priority or 1), stream, cq.put,
            tools=tools if tools_active else None,
            lora=self._lora_of(request.model),
        )
        first = True
        buffers: dict = {}
        for out in cq:
            if out.status is not None and not out.status.ok:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, out.status.message)
                return
            resp = llm_pb2.ChatResponse(
                id=rid,
                object="chat.completion.chunk" if stream else "chat.completion",
                created=int(time.time()),
                model=self._model,
            )
            for so in out.outputs:
                choice = llm_pb2.ChatChoice(index=so.index)
                finish = (
                    so.finish_reason.to_api_string()
                    if so.finish_reason is not None
                    else None
                )
                if stream:
                    if tools_active:
                        buf = buffers.setdefault(so.index, StreamToolBuffer())
                        ev = buf.feed(so.text, finished=finish is not None)
                        if ev is None:
                            continue
                        if ev[0] == "tool_calls":
                            _, content, calls = ev
                            if content:
                                choice.delta.content = content
                            choice.delta.tool_calls_json = _json.dumps(
                                [c.to_json() for c in calls]
                            )
                            if finish == "stop":
                                finish = "tool_calls"
                        else:
                            choice.delta.content = ev[1] or ""
                    else:
                        choice.delta.content = so.text
                    if first:
                        choice.delta.role = "assistant"
                else:
                    choice.message.role = "assistant"
                    text = so.text
                    if tools_active:
                        content, calls = parse_tool_calls(text)
                        if calls:
                            choice.message.tool_calls_json = _json.dumps(
                                [c.to_json() for c in calls]
                            )
                            text = content or ""
                            if finish == "stop":
                                finish = "tool_calls"
                    choice.message.content = text
                if finish is not None:
                    choice.finish_reason = finish
                resp.choices.append(choice)
            first = False
            if out.usage is not None:
                resp.usage.prompt_tokens = out.usage.num_prompt_tokens
                resp.usage.completion_tokens = out.usage.num_generated_tokens
                resp.usage.total_tokens = out.usage.num_total_tokens
            if stream and not resp.choices:
                continue  # everything buffered this round
            yield resp

    # -------------------------------------------------------------- models

    def list_models(self, request, context) -> llm_pb2.ListModelsResponse:
        return llm_pb2.ListModelsResponse(
            object="list",
            data=[
                llm_pb2.ModelInfo(
                    id=self._model, object="model",
                    created=int(time.time()), owned_by="scalellm_tpu",
                )
            ],
        )


def _generic_handlers(servicer: LLMServicer):
    """Register the three services without grpcio-tools codegen
    (generic method handlers over the protoc-generated messages)."""
    completion = grpc.method_handlers_generic_handler(
        "scalellm_tpu.Completion",
        {
            "Complete": grpc.unary_stream_rpc_method_handler(
                servicer.complete,
                request_deserializer=llm_pb2.CompletionRequest.FromString,
                response_serializer=llm_pb2.CompletionResponse.SerializeToString,
            )
        },
    )
    chat = grpc.method_handlers_generic_handler(
        "scalellm_tpu.Chat",
        {
            "Complete": grpc.unary_stream_rpc_method_handler(
                servicer.chat,
                request_deserializer=llm_pb2.ChatRequest.FromString,
                response_serializer=llm_pb2.ChatResponse.SerializeToString,
            )
        },
    )
    models = grpc.method_handlers_generic_handler(
        "scalellm_tpu.Models",
        {
            "List": grpc.unary_unary_rpc_method_handler(
                servicer.list_models,
                request_deserializer=llm_pb2.ListModelsRequest.FromString,
                response_serializer=llm_pb2.ListModelsResponse.SerializeToString,
            )
        },
    )
    return [completion, chat, models]


def serve(handler: LLMHandler, model_name: str, host: str, port: int,
          max_workers: int = 16) -> grpc.Server:
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(_generic_handlers(LLMServicer(handler, model_name)))
    server.add_insecure_port(f"{host}:{port}")
    server.start()
    logger.info("gRPC listening on %s:%d", host, port)
    return server


def main(argv: Optional[list] = None):
    logging.basicConfig(level=logging.INFO)
    from scalellm_tpu_torch.serve.api_server import build_arg_parser, engine_from_args, join_world, served_model_name

    args = build_arg_parser().parse_args(argv)
    if join_world(args):  # a follower host: no server
        return
    engine = engine_from_args(args)
    engine.start()
    server = serve(engine._handler, served_model_name(args), args.host, args.port)
    try:
        server.wait_for_termination()
    finally:
        engine.stop()


if __name__ == "__main__":
    main()
