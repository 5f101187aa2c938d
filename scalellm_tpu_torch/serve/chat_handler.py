"""/v1/chat/completions handlers, on the port's AsyncLLMEngine.

A copy of scalellm_tpu/serve/chat_handler.py: the response and the stream,
with the tool parser of utils/tools.py (parse_tool_calls, StreamToolBuffer);
a parsed call ends the choice with finish_reason "tool_calls".
"""

from __future__ import annotations

import json
import uuid

from scalellm_tpu_torch.llm_engine import AsyncLLMEngine
from scalellm_tpu_torch.serve.api_protocol import ChatCompletionRequest, now
from scalellm_tpu_torch.serve.http import Response, SSEResponse
from scalellm_tpu_torch.utils.chat import Message
from scalellm_tpu_torch.utils.tools import StreamToolBuffer, parse_tool_calls


def _messages(req: ChatCompletionRequest):
    return [Message.from_dict(m) for m in req.messages]


def _req_tools(req: ChatCompletionRequest):
    return req.tools if req.tools_active else None


def _logprobs_json(logprobs) -> dict | None:
    if not logprobs:
        return None
    content = []
    for lp in logprobs:
        content.append(
            {
                "token": lp.token,
                "logprob": lp.logprob,
                "top_logprobs": [
                    {"token": d.token, "logprob": d.logprob}
                    for d in (lp.top_logprobs or [])
                ],
            }
        )
    return {"content": content}


def _finished_message(req: ChatCompletionRequest, text: str):
    """(message dict, finish_reason override or None)."""
    if req.tools_active:
        content, calls = parse_tool_calls(text)
        if calls:
            return (
                {
                    "role": "assistant",
                    "content": content,
                    "tool_calls": [c.to_json() for c in calls],
                },
                "tool_calls",
            )
    return {"role": "assistant", "content": text}, None


async def generate_chat_response(
    engine: AsyncLLMEngine, req: ChatCompletionRequest, model_name: str,
    lora=None,
) -> Response:
    sp = req.to_sampling_params()
    request_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
    stream = await engine.schedule_chat_async(
        _messages(req), sp, priority=req.to_priority(), stream=False,
        tools=_req_tools(req), lora=lora,
    )
    choices = []
    usage = {}
    async for out in stream:
        if out.finished:
            for so in out.outputs:
                message, fr_override = _finished_message(req, so.text)
                finish = (
                    so.finish_reason.to_api_string() if so.finish_reason else None
                )
                if fr_override and finish == "stop":
                    finish = fr_override
                choices.append(
                    {
                        "index": so.index,
                        "message": message,
                        "logprobs": _logprobs_json(so.logprobs) if req.logprobs else None,
                        "finish_reason": finish,
                    }
                )
            if out.usage:
                usage = {
                    "prompt_tokens": out.usage.num_prompt_tokens,
                    "completion_tokens": out.usage.num_generated_tokens,
                    "total_tokens": out.usage.num_total_tokens,
                }
    return Response.json(
        {
            "id": request_id,
            "object": "chat.completion",
            "created": now(),
            "model": model_name,
            "choices": choices,
            "usage": usage,
        }
    )


async def generate_chat_stream(
    engine: AsyncLLMEngine, req: ChatCompletionRequest, model_name: str,
    sse: SSEResponse, lora=None,
) -> None:
    sp = req.to_sampling_params()
    request_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"

    def chunk_json(index, delta, finish=None):
        return json.dumps(
            {
                "id": request_id,
                "object": "chat.completion.chunk",
                "created": now(),
                "model": model_name,
                "choices": [
                    {"index": index, "delta": delta, "finish_reason": finish}
                ],
            }
        )

    try:
        stream = await engine.schedule_chat_async(
            _messages(req), sp, priority=req.to_priority(), stream=True,
            tools=_req_tools(req), lora=lora,
        )
        first = True

        async def send_delta(index, delta, finish=None):
            nonlocal first
            if first:
                delta = {"role": "assistant", **delta}
                first = False
            await sse.send(chunk_json(index, delta, finish))

        # Tool-call streaming: StreamToolBuffer holds back text once an
        # opener (or a possible opener prefix) appears; on finish the parsed
        # calls are emitted as a single delta (finish_reason "tool_calls").
        buffers: dict[int, StreamToolBuffer] = {}
        async for out in stream:
            for so in out.outputs:
                finish = (
                    so.finish_reason.to_api_string() if so.finish_reason else None
                )
                if not req.tools_active:
                    await send_delta(so.index, {"content": so.text}, finish)
                    continue
                buf = buffers.setdefault(so.index, StreamToolBuffer())
                ev = buf.feed(so.text, finished=finish is not None)
                if ev is None:
                    continue
                if ev[0] == "tool_calls":
                    _, content, calls = ev
                    delta = {
                        "tool_calls": [
                            {**c.to_json(), "index": i}
                            for i, c in enumerate(calls)
                        ]
                    }
                    if content:
                        delta["content"] = content
                    await send_delta(
                        so.index,
                        delta,
                        "tool_calls" if finish == "stop" else finish,
                    )
                else:
                    await send_delta(so.index, {"content": ev[1] or ""}, finish)
        await sse.done()
    except Exception as e:
        await sse.send(json.dumps({"error": {"message": str(e)}}))
        await sse.done()
