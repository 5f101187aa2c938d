"""/v1/completions handlers, on the port's AsyncLLMEngine.

A copy of scalellm_tpu/serve/completion_handler.py. A list of prompts is
served one after another. A client that drops a stream does not cancel its
request: it runs to max_tokens, as in the reference.
"""

from __future__ import annotations

import json
import uuid
from typing import List

from scalellm_tpu_torch.llm_engine import AsyncLLMEngine
from scalellm_tpu_torch.serve.api_protocol import CompletionRequest, now
from scalellm_tpu_torch.serve.http import Response, SSEResponse


def _logprobs_json(logprobs, prompt_logprobs=None) -> dict | None:
    if not logprobs and not prompt_logprobs:
        return None
    tokens, token_lps, top = [], [], []
    if prompt_logprobs:
        # echo mode: prompt entries first; position 0 has no conditioning
        # context — OpenAI emits null for its logprob.
        for lp in prompt_logprobs:
            if lp is None:
                tokens.append("")
                token_lps.append(None)
                top.append(None)
            else:
                tokens.append(lp.token)
                token_lps.append(lp.logprob)
                top.append(
                    {d.token: d.logprob for d in (lp.top_logprobs or [])}
                    or None
                )
    for lp in logprobs or []:
        tokens.append(lp.token)
        token_lps.append(lp.logprob)
        top.append(
            {d.token: d.logprob for d in (lp.top_logprobs or [])} or None
        )
    return {
        "tokens": tokens,
        "token_logprobs": token_lps,
        "top_logprobs": top,
        "text_offset": [],
    }


def _choice(seq_out, include_logprobs: bool, prompt_logprobs=None) -> dict:
    return {
        "index": seq_out.index,
        "text": seq_out.text,
        "logprobs": _logprobs_json(seq_out.logprobs, prompt_logprobs)
        if include_logprobs
        else None,
        "finish_reason": seq_out.finish_reason.to_api_string()
        if seq_out.finish_reason
        else None,
    }


async def generate_completion_response(
    engine: AsyncLLMEngine, req: CompletionRequest, model_name: str,
    lora=None,
) -> Response:
    prompts: List[str] = req.prompt if isinstance(req.prompt, list) else [req.prompt]
    sp = req.to_sampling_params()
    request_id = f"cmpl-{uuid.uuid4().hex[:24]}"
    include_lp = req.logprobs is not None

    all_choices = []
    usage = {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0}
    for prompt in prompts:
        stream = await engine.schedule_async(
            prompt, sp, priority=req.to_priority(), stream=False, lora=lora
        )
        async for out in stream:
            if out.finished:
                for so in out.outputs:
                    c = _choice(
                        so, include_lp,
                        prompt_logprobs=out.prompt_logprobs if req.echo else None,
                    )
                    c["index"] = len(all_choices)
                    all_choices.append(c)
                if out.usage:
                    usage["prompt_tokens"] += out.usage.num_prompt_tokens
                    usage["completion_tokens"] += out.usage.num_generated_tokens
                    usage["total_tokens"] += out.usage.num_total_tokens
    return Response.json(
        {
            "id": request_id,
            "object": "text_completion",
            "created": now(),
            "model": model_name,
            "choices": all_choices,
            "usage": usage,
        }
    )


async def generate_completion_stream(
    engine: AsyncLLMEngine, req: CompletionRequest, model_name: str,
    sse: SSEResponse, lora=None,
) -> None:
    prompt = req.prompt[0] if isinstance(req.prompt, list) else req.prompt
    sp = req.to_sampling_params()
    request_id = f"cmpl-{uuid.uuid4().hex[:24]}"
    include_lp = req.logprobs is not None
    try:
        stream = await engine.schedule_async(
            prompt, sp, priority=req.to_priority(), stream=True, lora=lora
        )
        async for out in stream:
            for so in out.outputs:
                chunk = {
                    "id": request_id,
                    "object": "text_completion",
                    "created": now(),
                    "model": model_name,
                    "choices": [_choice(so, include_lp)],
                }
                await sse.send(json.dumps(chunk))
        await sse.done()
    except Exception as e:
        await sse.send(json.dumps({"error": {"message": str(e)}}))
        await sse.done()
