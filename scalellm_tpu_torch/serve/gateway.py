"""Standalone REST -> gRPC gateway with data-parallel replica routing.

A copy of scalellm_tpu/serve/gateway.py (it holds no engine code): a
separate process that exposes the OpenAI REST surface and proxies every
call to one or more gRPC serving processes (serve/grpc_server.py, of
either package: the wire names are the same), streaming responses as
server-sent events.

Data parallelism: pass several --grpc-server endpoints (comma-separated or
repeated), each a full engine replica on its own card. The gateway routes
every request to the healthy replica with the fewest outstanding requests
(least-loaded), prefers a prompt's prefix-affinity replica while its
backlog is within AFFINITY_SLACK, marks a replica down for a cooldown
after a transport failure, and retries non-streaming calls once on
another replica.

Run:
  python -m scalellm_tpu_torch.serve.gateway \
      --grpc-server 10.0.0.1:8500,10.0.0.2:8500 --http-server 0.0.0.0:8080

The gateway performs full REST request validation (shared api_protocol
parsers) before the proxy hop, so malformed requests are rejected at the
edge without touching the serving tier.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from typing import Optional, Union

import grpc
import grpc.aio

from scalellm_tpu_torch.serve.api_protocol import (
    ChatCompletionRequest,
    CompletionRequest,
    ValidationError,
    error_json,
    status_to_http,
)
from scalellm_tpu_torch.serve.http import HttpServer, Request, Response, SSEResponse
from scalellm_tpu_torch.serve.pb import llm_pb2

logger = logging.getLogger(__name__)

_PRIORITY = {"high": 0, "normal": 1, "low": 2}


def _sampling_pb(body: Union[CompletionRequest, ChatCompletionRequest]) -> llm_pb2.SamplingParams:
    sp = llm_pb2.SamplingParams(
        max_tokens=body.max_tokens,
        n=body.n,
        frequency_penalty=body.frequency_penalty,
        presence_penalty=body.presence_penalty,
        repetition_penalty=body.repetition_penalty,
        temperature=body.temperature,
        top_p=body.top_p,
        top_k=body.top_k,
        ignore_eos=body.ignore_eos,
        skip_special_tokens=body.skip_special_tokens,
    )
    if isinstance(body, CompletionRequest):
        sp.echo = body.echo
        if body.best_of is not None:
            sp.best_of = body.best_of
        if body.logprobs is not None:
            sp.logprobs = True
            sp.top_logprobs = body.logprobs
    else:
        if body.logprobs:
            sp.logprobs = True
            sp.top_logprobs = body.top_logprobs
    if body.seed is not None:
        sp.seed = body.seed
    for s in body.stop or []:
        sp.stop.append(s)
    for t in body.stop_token_ids or []:
        sp.stop_token_ids.append(t)
    for tid, bias in (body.logit_bias or {}).items():
        sp.logit_bias[tid] = bias
    if body.guided_regex is not None:
        sp.guided_regex = body.guided_regex
    if body.guided_json is not None:
        gj = body.guided_json
        sp.guided_json = gj if isinstance(gj, str) else json.dumps(gj)
    for c in body.guided_choice or []:
        sp.guided_choice.append(c)
    return sp


def _usage_json(usage) -> Optional[dict]:
    if usage is None:
        return None
    return {
        "prompt_tokens": usage.prompt_tokens,
        "completion_tokens": usage.completion_tokens,
        "total_tokens": usage.total_tokens,
    }


def _completion_json(resp: llm_pb2.CompletionResponse) -> dict:
    choices = []
    for c in resp.choices:
        lp = None
        if len(c.logprobs):
            lp = {
                "tokens": [e.token for e in c.logprobs],
                "token_logprobs": [e.logprob for e in c.logprobs],
                "top_logprobs": [
                    {d.token: d.logprob for d in e.top_logprobs} or None
                    for e in c.logprobs
                ],
            }
        choices.append(
            {
                "index": c.index,
                "text": c.text,
                "logprobs": lp,
                "finish_reason": c.finish_reason if c.HasField("finish_reason") else None,
            }
        )
    out = {
        "id": resp.id,
        "object": resp.object,
        "created": resp.created,
        "model": resp.model,
        "choices": choices,
    }
    if resp.HasField("usage"):
        out["usage"] = _usage_json(resp.usage)
    return out


def _chat_json(resp: llm_pb2.ChatResponse, stream: bool) -> dict:
    choices = []
    for c in resp.choices:
        entry = {
            "index": c.index,
            "finish_reason": c.finish_reason if c.HasField("finish_reason") else None,
        }
        if stream:
            delta = {}
            if c.delta.role:
                delta["role"] = c.delta.role
            if c.delta.content:
                delta["content"] = c.delta.content
            if c.delta.HasField("tool_calls_json"):
                delta["tool_calls"] = [
                    {**tc, "index": i}
                    for i, tc in enumerate(json.loads(c.delta.tool_calls_json))
                ]
            entry["delta"] = delta
        else:
            msg = {"role": c.message.role, "content": c.message.content or None}
            if c.message.HasField("tool_calls_json"):
                msg["tool_calls"] = json.loads(c.message.tool_calls_json)
            elif msg["content"] is None:
                msg["content"] = ""
            entry["message"] = msg
        choices.append(entry)
    out = {
        "id": resp.id,
        "object": resp.object,
        "created": resp.created,
        "model": resp.model,
        "choices": choices,
    }
    if resp.HasField("usage"):
        out["usage"] = _usage_json(resp.usage)
    return out


def _grpc_error_response(e: grpc.aio.AioRpcError) -> Response:
    code = e.code()
    status = {
        grpc.StatusCode.INVALID_ARGUMENT: 400,
        grpc.StatusCode.RESOURCE_EXHAUSTED: 429,
        grpc.StatusCode.UNAVAILABLE: 503,
        grpc.StatusCode.DEADLINE_EXCEEDED: 504,
    }.get(code, 500)
    return Response.json(error_json(e.details() or code.name), status)


class Replica:
    """One gRPC serving process (a full engine replica)."""

    def __init__(self, addr: str):
        self.addr = addr
        self.channel = grpc.aio.insecure_channel(addr)
        # Generic stubs over the protoc message classes (no grpcio-tools
        # codegen, same approach as the server's generic handlers).
        self.complete = self.channel.unary_stream(
            "/scalellm_tpu.Completion/Complete",
            request_serializer=llm_pb2.CompletionRequest.SerializeToString,
            response_deserializer=llm_pb2.CompletionResponse.FromString,
        )
        self.chat = self.channel.unary_stream(
            "/scalellm_tpu.Chat/Complete",
            request_serializer=llm_pb2.ChatRequest.SerializeToString,
            response_deserializer=llm_pb2.ChatResponse.FromString,
        )
        self.models = self.channel.unary_unary(
            "/scalellm_tpu.Models/List",
            request_serializer=llm_pb2.ListModelsRequest.SerializeToString,
            response_deserializer=llm_pb2.ListModelsResponse.FromString,
        )
        self.inflight = 0
        self.served = 0
        self.failures = 0
        self.down_until = 0.0  # event-loop clock cooldown after failure

    def healthy(self, now: float) -> bool:
        return now >= self.down_until


class BackendPool:
    """Least-outstanding-requests router over engine replicas, with a
    failure cooldown circuit breaker and prefix-cache affinity.

    Affinity: requests carrying the same prompt prefix hash to the same
    replica so its prefix cache serves the shared tokens (multi-turn chat,
    shared system prompts). Load still wins: the affinity replica is only
    preferred while its backlog is within AFFINITY_SLACK of the least-
    loaded one."""

    COOLDOWN_S = 5.0
    AFFINITY_SLACK = 4  # max extra inflight the affinity replica may carry
    AFFINITY_PREFIX_CHARS = 512

    def __init__(self, addrs):
        assert addrs
        self.replicas = [Replica(a) for a in addrs]
        self._rr = 0  # tie-break rotation

    def pick(self, exclude=None, affinity_key: Optional[str] = None) -> Replica:
        now = asyncio.get_running_loop().time()
        pool = [
            r for r in self.replicas
            if r.healthy(now) and (exclude is None or r is not exclude)
        ]
        if not pool:  # all down: try anyway (cooldown is advisory)
            pool = [r for r in self.replicas if exclude is None or r is not exclude]
        if not pool:
            pool = self.replicas
        self._rr += 1
        least = min(
            enumerate(pool),
            key=lambda ir: (ir[1].inflight, (ir[0] + self._rr) % len(pool)),
        )[1]
        if affinity_key is not None and len(pool) > 1:
            import zlib

            idx = zlib.crc32(
                affinity_key[: self.AFFINITY_PREFIX_CHARS].encode()
            ) % len(self.replicas)
            preferred = self.replicas[idx]
            if (
                preferred in pool
                and preferred.inflight <= least.inflight + self.AFFINITY_SLACK
            ):
                return preferred
        return least

    def mark_down(self, r: Replica) -> None:
        r.failures += 1
        r.down_until = asyncio.get_running_loop().time() + self.COOLDOWN_S
        logger.warning("replica %s marked down for %.0fs", r.addr, self.COOLDOWN_S)

    def mark_up(self, r: Replica) -> None:
        r.down_until = 0.0

    async def close(self) -> None:
        for r in self.replicas:
            await r.channel.close()


class Gateway:
    """REST edge tier routing across one or more gRPC serving replicas."""

    def __init__(self, grpc_addrs):
        if isinstance(grpc_addrs, str):
            grpc_addrs = [a.strip() for a in grpc_addrs.split(",") if a.strip()]
        self.pool = BackendPool(grpc_addrs)
        self.http = HttpServer()
        self._routes()

    # ------------------------------------------------------------- streaming

    async def _forward_stream(self, replica, call, sse: SSEResponse, to_json) -> None:
        """SSE forwarding of a server-streaming call (reference:
        gateway/forwarder.go:16 ForwardResponseStream)."""
        try:
            async for resp in call:
                await sse.send(json.dumps(to_json(resp)))
            await sse.done()
            replica.served += 1
        except grpc.aio.AioRpcError as e:
            if e.code() == grpc.StatusCode.UNAVAILABLE:
                self.pool.mark_down(replica)
            await sse.send(json.dumps(error_json(e.details() or e.code().name)))
            await sse.done()
        except Exception:
            logger.exception("stream forwarding error")
            await sse.aborted()
        finally:
            replica.inflight -= 1

    async def _unary_stream_final(
        self, make_call, to_json, affinity_key: Optional[str] = None
    ) -> Response:
        """Drain a server-streaming call to its final message; on transport
        failure retry ONCE on a different replica (the request never started
        generating there)."""
        first = self.pool.pick(affinity_key=affinity_key)
        for attempt, replica in enumerate((first, None)):
            if replica is None:
                replica = self.pool.pick(exclude=first)
                if replica is first:
                    break
            replica.inflight += 1
            try:
                final = None
                async for resp in make_call(replica):
                    final = resp
                if final is None:
                    return Response.json(error_json("empty upstream response"), 500)
                replica.served += 1
                return Response.json(to_json(final))
            except grpc.aio.AioRpcError as e:
                if e.code() == grpc.StatusCode.UNAVAILABLE and attempt == 0:
                    self.pool.mark_down(replica)
                    continue
                if e.code() == grpc.StatusCode.UNAVAILABLE:
                    self.pool.mark_down(replica)
                return _grpc_error_response(e)
            finally:
                replica.inflight -= 1
        return Response.json(error_json("no replica available"), 503)

    # ---------------------------------------------------------------- routes

    def _routes(self) -> None:
        http = self.http

        @http.route("GET", "/health")
        async def health(req: Request):
            # OK when ANY replica answers (DP tier stays up through single
            # replica failures).
            for r in self.pool.replicas:
                try:
                    await asyncio.wait_for(r.models(llm_pb2.ListModelsRequest()), 5)
                    self.pool.mark_up(r)
                    return Response.text("OK")
                except Exception:
                    continue
            return Response.text("upstream unavailable", 503)

        @http.route("GET", "/gateway/replicas")
        async def replicas(req: Request):
            now = asyncio.get_running_loop().time()
            return Response.json(
                {
                    "replicas": [
                        {
                            "addr": r.addr,
                            "healthy": r.healthy(now),
                            "inflight": r.inflight,
                            "served": r.served,
                            "failures": r.failures,
                        }
                        for r in self.pool.replicas
                    ]
                }
            )

        @http.route("GET", "/v1/models")
        async def models(req: Request):
            try:
                resp = await self.pool.pick().models(llm_pb2.ListModelsRequest())
            except grpc.aio.AioRpcError as e:
                return _grpc_error_response(e)
            return Response.json(
                {
                    "object": "list",
                    "data": [
                        {
                            "id": m.id,
                            "object": m.object,
                            "created": m.created,
                            "owned_by": m.owned_by,
                        }
                        for m in resp.data
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
            prompt = body.prompt if isinstance(body.prompt, str) else body.prompt[0]
            pb = llm_pb2.CompletionRequest(
                model=body.model,
                prompt=prompt,
                sampling=_sampling_pb(body),
                stream=body.stream,
                priority=_PRIORITY.get(body.priority, 1),
            )
            akey = prompt
            if body.stream:
                replica = self.pool.pick(affinity_key=akey)
                replica.inflight += 1
                sse = SSEResponse()
                asyncio.get_running_loop().create_task(
                    self._forward_stream(
                        replica, replica.complete(pb), sse, _completion_json
                    )
                )
                return sse
            return await self._unary_stream_final(
                lambda r: r.complete(pb), _completion_json, affinity_key=akey
            )

        @http.route("POST", "/v1/chat/completions")
        async def chat(req: Request):
            try:
                body = ChatCompletionRequest.from_json(req.json())
            except ValidationError as e:
                return Response.json(error_json(e.message), status_to_http(e.code))
            except Exception as e:
                return Response.json(error_json(f"invalid JSON: {e}"), 400)
            def msg_pb(m):
                pb_m = llm_pb2.ChatMessage(
                    role=m["role"], content=m.get("content") or ""
                )
                if m.get("tool_calls"):
                    pb_m.tool_calls_json = json.dumps(m["tool_calls"])
                if m.get("tool_call_id"):
                    pb_m.tool_call_id = m["tool_call_id"]
                return pb_m

            pb = llm_pb2.ChatRequest(
                model=body.model,
                messages=[msg_pb(m) for m in body.messages],
                sampling=_sampling_pb(body),
                stream=body.stream,
                priority=_PRIORITY.get(body.priority, 1),
            )
            if body.tools:
                pb.tools_json = json.dumps(body.tools)
                pb.tool_choice_json = json.dumps(body.tool_choice)
            # affinity on the conversation head: system + first user turn
            akey = json.dumps(body.messages[:2])
            if body.stream:
                replica = self.pool.pick(affinity_key=akey)
                replica.inflight += 1
                sse = SSEResponse()
                asyncio.get_running_loop().create_task(
                    self._forward_stream(
                        replica, replica.chat(pb), sse,
                        lambda r: _chat_json(r, stream=True),
                    )
                )
                return sse
            return await self._unary_stream_final(
                lambda r: r.chat(pb), lambda r: _chat_json(r, stream=False),
                affinity_key=akey,
            )

    # ------------------------------------------------------------------ main

    async def run(self, host: str, port: int) -> None:
        await self.http.start(host, port)
        logger.info(
            "gateway %s:%d -> %d replica(s): %s",
            host, port, len(self.pool.replicas),
            ",".join(r.addr for r in self.pool.replicas),
        )
        await self.http.serve_forever()

    async def close(self) -> None:
        await self.http.stop()
        await self.pool.close()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--grpc-server", action="append", default=None,
        help="gRPC replica endpoint; repeat or comma-separate for data-"
        "parallel replicas (reference: gateway/main.go grpc-server flag)",
    )
    p.add_argument("--http-server", default="0.0.0.0:8080", help="HTTP bind addr")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    host, _, port = args.http_server.rpartition(":")
    addrs = []
    for a in args.grpc_server or ["127.0.0.1:8888"]:
        addrs.extend(x.strip() for x in a.split(",") if x.strip())

    async def amain():
        # The grpc.aio channels must be created with the event loop running
        # (they bind to the current loop).
        gw = Gateway(addrs)
        await gw.run(host or "0.0.0.0", int(port))

    asyncio.run(amain())


if __name__ == "__main__":
    main()
