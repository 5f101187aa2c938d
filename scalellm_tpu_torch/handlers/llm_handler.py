"""LLMHandler — the single front door
(counterpart of scalellm_tpu/handlers/llm_handler.py).

Builds the engine from the options, owns the scheduler loop thread and the
request-handling thread pool, validates sampling params, applies chat
templates and keeps tokenization off the scheduler's hot path.

The options keep the reference package's field names and defaults: CUDA
graphs on (enable_cuda_graph, one graph per step bucket, where the
reference warms its jit bucket cache) with warmup_mode "fast", async
scheduling on (enable_async_scheduling: one step in flight) and one decode
step a dispatch (num_decode_steps; N > 1 runs N micro-steps in one graph).
kv_cache_dtype="int8" serves int8 KV pages, host_swap_bytes > 0 stages
preempted sequences' KV pages in host memory. draft_model_path with
num_speculative_tokens = k serves draft-model speculative decoding
(SpeculativeEngine), k > 0 alone prompt lookup (NgramSpeculativeEngine).
lora_modules ({name: HF PEFT adapter directory}) serves LoRA adapters on one
engine, each request picking its adapter by name (`lora`; an unknown name is
an INVALID_ARGUMENT status), a batch mixing the base model and several
adapters; LoRA with speculative decoding or multi-host serving is a
ValueError, as in the reference, and so is LoRA on an MoE or MLA model
(and LoRA with tp_size > 1).
model_args_overrides (`path=value` strings, utils/args_override.py) are
applied to the checkpoint's ModelArgs before the model is built. Per
request, guided decoding (guided_regex / guided_json / guided_choice)
compiles its constraint once into a TokenFsm (the handler's FsmCache) that
masks every step's logits; with speculative decoding it is an
INVALID_ARGUMENT status, as in the reference. schedule_chat_async takes
OpenAI tool definitions (`tools`) for the chat template.

Tensor parallelism: tp_size = N > 1 builds a DistributedLLMEngine
(engine/distributed.py) over N ranks: this process is rank 0 on the first
of `devices` ("auto": cuda:0 ... cuda:N-1; "cpu"; or one device a rank,
"cuda:0,cuda:0" to share a card), and it spawns the other ranks;
sequence_parallel adds Megatron SP. distributed=True serves on a world that
the caller has joined (parallel/multihost.py's init_distributed, one
process a host: api_server's --coordinator), rank 0 serving and the others
following. With either, the options this slice does not carry raise
NotImplementedError naming the option to turn off (CUDA graphs, async
scheduling, num_decode_steps > 1, speculative decoding, host_swap_bytes;
DeepSeek-V2's MLA model refuses tp itself), and a request with
prompt_logprobs is an INVALID_ARGUMENT status: its scoring step is one the
followers do not run. Nothing falls back to one rank. stop() also closes
the engine: the followers get the stop header and are joined.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence


from scalellm_tpu_torch.constrained.guided import FsmCache, constraint_regex
from scalellm_tpu_torch.engine.batch import TOKEN_BUCKETS
from scalellm_tpu_torch.engine.executor import WARMUP_MODES
from scalellm_tpu_torch.engine.llm_engine import KV_CACHE_DTYPES, EngineOptions, LLMEngine
from scalellm_tpu_torch.errors import ValidationError
from scalellm_tpu_torch.request.output import Priority, RequestOutput, Status, StatusCode
from scalellm_tpu_torch.request.request import OnOutput, Request
from scalellm_tpu_torch.request.stopping import StoppingCriteria
from scalellm_tpu_torch.sampling.params import SamplingParams
from scalellm_tpu_torch.scheduler.continuous_scheduler import (
    ContinuousScheduler,
    SchedulerOptions,
)
from scalellm_tpu_torch.scheduler.response_handler import ResponseHandler
from scalellm_tpu_torch.utils.chat import Message, apply_chat_template
from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS

logger = logging.getLogger(__name__)


@dataclass
class LLMHandlerOptions:
    model_path: str = ""
    # "auto" = cuda; "cuda", "cuda:N" or "cpu" name the device.
    devices: str = "auto"
    draft_model_path: Optional[str] = None
    block_size: int = 16
    max_cache_size: int = 0
    max_memory_utilization: float = 0.9
    enable_prefix_cache: bool = True
    enable_cuda_graph: bool = True  # one CUDA graph per step bucket
    max_tokens_per_batch: int = 512
    max_seqs_per_batch: int = 128
    num_speculative_tokens: int = 0
    num_handling_threads: int = 4
    tp_size: int = 1
    sequence_parallel: bool = False
    num_blocks: int = 0  # direct override (tests)
    max_context_len: int = 0  # 0 = model's max_position_embeddings
    kv_cache_dtype: str = "auto"
    warmup_mode: str = "fast"  # "off" | "fast" | "full" (buckets captured at init)
    distributed: bool = False
    quantize_lm_head: "bool | str" = False
    quantize: str = ""
    host_swap_bytes: int = 0
    # Async stepping: one step in flight (SchedulerOptions).
    enable_async_scheduling: bool = True
    # Decode micro-steps per dispatch (SchedulerOptions.num_decode_steps).
    num_decode_steps: int = 1
    lora_modules: "Optional[dict]" = None
    # `path=value` ModelArgs overrides (utils/args_override.py).
    model_args_overrides: "Optional[list]" = None

    def device(self) -> str:
        return "cuda" if self.devices == "auto" else self.devices

    def check_ported(self) -> None:
        """Raise NotImplementedError for options that ask for unported
        features; ValueError for an unknown warmup_mode or kv_cache_dtype,
        and for LoRA with speculative decoding or multi-host serving (the
        reference's rule)."""
        if self.warmup_mode not in WARMUP_MODES:
            raise ValueError(f"warmup_mode must be one of {WARMUP_MODES}, got {self.warmup_mode!r}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, got {self.kv_cache_dtype!r}")
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")
        if self.lora_modules and (self.draft_model_path or self.num_speculative_tokens > 0 or self.distributed
                                  or self.tp_size > 1):
            raise ValueError("LoRA adapters are not supported with speculative decoding, multi-host serving "
                             "or tp_size > 1")
        if not self.parallel:
            return
        asks = {
            "enable_cuda_graph (set enable_cuda_graph=False)": self.enable_cuda_graph,
            "enable_async_scheduling (set enable_async_scheduling=False)": self.enable_async_scheduling,
            "num_decode_steps > 1 (set num_decode_steps=1)": self.num_decode_steps > 1,
            "speculative decoding (drop draft_model_path / num_speculative_tokens)":
                bool(self.draft_model_path) or self.num_speculative_tokens > 0,
            "host_swap_bytes (set host_swap_bytes=0)": self.host_swap_bytes > 0,
        }
        asked = [name for name, on in asks.items() if on]
        if asked:
            raise NotImplementedError(f"not ported with tp_size > 1 or distributed serving: {', '.join(asked)}")

    def engine_options(self) -> EngineOptions:
        """The EngineOptions of these options (one rank's; each rank's own
        device is set where the ranks are started)."""
        return EngineOptions(
            model_path=self.model_path,
            device=self.device(),
            block_size=self.block_size,
            max_cache_size=self.max_cache_size,
            max_memory_utilization=self.max_memory_utilization,
            enable_prefix_cache=self.enable_prefix_cache,
            num_blocks=self.num_blocks,
            quantize=self.quantize,
            quantize_lm_head=self.quantize_lm_head,
            enable_cuda_graph=self.enable_cuda_graph,
            warmup_mode=self.warmup_mode,
            max_tokens_per_batch=self.max_tokens_per_batch,
            max_seqs_per_batch=self.max_seqs_per_batch,
            max_context_len=self.max_context_len,
            num_decode_steps=self.num_decode_steps,
            kv_cache_dtype=self.kv_cache_dtype,
            host_swap_bytes=self.host_swap_bytes,
            draft_model_path=self.draft_model_path or "",
            num_speculative_tokens=self.num_speculative_tokens,
            lora_modules=self.lora_modules,
            model_args_overrides=self.model_args_overrides,
            sequence_parallel=self.sequence_parallel,
        )

    @property
    def parallel(self) -> bool:
        """Whether the engine runs over several ranks."""
        return self.tp_size > 1 or self.distributed


class LLMHandler:
    def __init__(self, options: LLMHandlerOptions):
        options.check_ported()
        self.options = options
        engine_opts = options.engine_options()
        if options.parallel:
            from scalellm_tpu_torch.engine.distributed import DistributedLLMEngine, rank_devices

            if options.distributed:  # a world the caller has joined
                self.engine = DistributedLLMEngine(engine_opts)
            else:
                self.engine = DistributedLLMEngine.launch(engine_opts, rank_devices(options.devices,
                                                                                    options.tp_size))
        elif options.draft_model_path:
            from scalellm_tpu_torch.speculative.speculative_engine import SpeculativeEngine

            self.engine = SpeculativeEngine(engine_opts)
        elif options.num_speculative_tokens > 0:
            # No draft model: prompt lookup (n-gram) speculation.
            from scalellm_tpu_torch.speculative.ngram import NgramSpeculativeEngine

            self.engine = NgramSpeculativeEngine(engine_opts)
        else:
            self.engine = LLMEngine(engine_opts)
        self.tokenizer = self.engine.tokenizer
        self.model_args = self.engine.model_args
        # Compiled guided-decoding constraints, shared by the handling threads.
        self._fsm_cache = FsmCache()

        self._response_handler = ResponseHandler(self.tokenizer, threaded=True)
        self.scheduler = ContinuousScheduler(
            self.engine,
            SchedulerOptions(
                max_tokens_per_batch=options.max_tokens_per_batch,
                max_seqs_per_batch=options.max_seqs_per_batch,
                enable_async_scheduling=options.enable_async_scheduling,
                num_decode_steps=options.num_decode_steps,
                num_speculative_tokens=options.num_speculative_tokens,
            ),
            response_handler=self._response_handler,
        )
        # Request-handling pool keeps tokenization/templating off the
        # scheduler loop.
        self._pool = ThreadPoolExecutor(
            max_workers=options.num_handling_threads, thread_name_prefix="handler"
        )
        self._loop_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._max_context_len = options.max_context_len or (
            self.model_args.max_position_embeddings
        )

    # ------------------------------------------------------------- scheduling

    def schedule_async(
        self,
        prompt: str,
        sp: SamplingParams,
        priority: Priority = Priority.NORMAL,
        stream: bool = False,
        callback: OnOutput = lambda out: True,
        lora: Optional[str] = None,
    ) -> None:
        """Validate, tokenize and enqueue, off the caller's thread; `lora`
        names the request's adapter (None: the base model)."""
        self._pool.submit(self._handle, prompt, None, sp, priority, stream, callback, None, lora)

    def schedule_chat_async(
        self,
        messages: Sequence[Message],
        sp: SamplingParams,
        priority: Priority = Priority.NORMAL,
        stream: bool = False,
        callback: OnOutput = lambda out: True,
        tools=None,
        lora: Optional[str] = None,
    ) -> None:
        """Apply the chat template (with the OpenAI tool definitions
        `tools`), then as schedule_async."""
        self._pool.submit(
            self._handle, None, list(messages), sp, priority, stream, callback, tools, lora
        )

    def _handle(self, prompt, messages, sp, priority, stream, callback, tools=None, lora=None) -> None:
        t0 = time.monotonic()
        try:
            sp.verify()
            if messages is not None:
                prompt = self.apply_chat_template(messages, tools=tools)
            prompt_tokens = self.tokenizer.encode(prompt)
            if not prompt_tokens:
                raise ValidationError(StatusCode.INVALID_ARGUMENT, "empty prompt")
            if len(prompt_tokens) >= self._max_context_len:
                raise ValidationError(
                    StatusCode.INVALID_ARGUMENT,
                    f"prompt ({len(prompt_tokens)} tokens) exceeds max context "
                    f"length {self._max_context_len}",
                )
            if len(prompt_tokens) + sp.max_tokens > TOKEN_BUCKETS[-1]:
                raise ValidationError(
                    StatusCode.INVALID_ARGUMENT, "prompt + max_tokens exceeds engine limit"
                )
            kv_capacity = self.scheduler.max_seq_tokens
            if len(prompt_tokens) + sp.max_tokens > kv_capacity:
                raise ValidationError(
                    StatusCode.RESOURCE_EXHAUSTED,
                    f"prompt + max_tokens ({len(prompt_tokens) + sp.max_tokens}"
                    f" tokens) exceeds KV cache capacity ({kv_capacity})",
                )
            if sp.prompt_logprobs is not None and self.options.parallel:
                raise ValidationError(StatusCode.INVALID_ARGUMENT,
                                      "prompt_logprobs is not supported with tensor parallelism")
            guided_fsm = self._guided_fsm(sp) if sp.has_guided else None
            lora_slot = 0
            if lora:
                meta = getattr(self.engine, "lora_meta", None)
                if meta is None or lora not in meta.names:
                    raise ValidationError(StatusCode.INVALID_ARGUMENT, f"unknown LoRA adapter {lora!r}")
                lora_slot = meta.slot_of(lora)
            request = Request(
                prompt=prompt,
                prompt_tokens=prompt_tokens,
                sampling_params=sp,
                stopping_criteria=self._build_stopping_criteria(sp),
                on_output=callback,
                stream=stream,
                priority=priority,
                enable_prefix_cache=self.options.enable_prefix_cache,
                guided_fsm=guided_fsm,
                lora_slot=lora_slot,
            )
            if not self.scheduler.schedule(request):
                raise ValidationError(StatusCode.RESOURCE_EXHAUSTED, "request queue is full")
            COUNTERS.inc("request_handling_total")
            HISTOGRAMS.observe("request_handling_latency_seconds", time.monotonic() - t0)
        except ValidationError as e:
            callback(RequestOutput(status=Status(e.code, e.message), finished=True))
        except Exception as e:  # report, don't kill the pool thread
            logger.exception("request handling failed")
            callback(RequestOutput(status=Status(StatusCode.UNKNOWN, str(e)), finished=True))

    def _guided_fsm(self, sp: SamplingParams):
        """The request's compiled constraint (FsmCache: once per regex and
        set of end ids). Refused with speculative decoding: draft proposals
        bypass the mask."""
        if self.options.num_speculative_tokens > 0:
            raise ValidationError(
                StatusCode.INVALID_ARGUMENT,
                "guided decoding is not supported with speculative "
                "decoding (draft proposals bypass the grammar mask)",
            )
        eos_ids = tuple(
            {self.model_args.eos_token_id}
            | set(self.model_args.stop_token_ids)
            | set(sp.stop_token_ids or [])
        )
        try:
            return self._fsm_cache.get(constraint_regex(sp), self.tokenizer, eos_ids)
        except ValueError as e:
            raise ValidationError(StatusCode.INVALID_ARGUMENT, f"invalid guided constraint: {e}")

    def _build_stopping_criteria(self, sp: SamplingParams) -> StoppingCriteria:
        stop_sequences = [
            self.tokenizer.encode(s, add_special_tokens=False) for s in sp.stop or []
        ]
        stop_ids = set(sp.stop_token_ids or [])
        stop_ids.update(self.model_args.stop_token_ids)
        return StoppingCriteria(
            max_tokens=sp.max_tokens,
            max_context_len=self._max_context_len,
            eos_token_id=self.model_args.eos_token_id,
            ignore_eos=sp.ignore_eos,
            stop_token_ids=stop_ids,
            stop_sequences=stop_sequences,
        )

    def apply_chat_template(self, messages: Sequence[Message], tools=None) -> str:
        return apply_chat_template(
            messages,
            jinja_template=getattr(self.tokenizer, "chat_template", None),
            model_type=self.model_args.model_type,
            tools=tools,
        )

    def encode(self, text: str) -> List[int]:
        return self.tokenizer.encode(text)

    def decode(self, tokens: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tokenizer.decode(tokens, skip_special_tokens)

    # ------------------------------------------------------------- loop

    def start(self) -> None:
        """Start the scheduler loop thread."""
        if self._loop_thread is not None:
            return
        self._stop_event.clear()

        def loop():
            while not self._stop_event.is_set():
                try:
                    self.scheduler.step(timeout_s=0.05)
                except Exception:
                    logger.exception("scheduler step failed")
                    time.sleep(0.1)

        self._loop_thread = threading.Thread(target=loop, name="scheduler", daemon=True)
        self._loop_thread.start()

    def stop(self) -> None:
        """Stop the scheduler loop and release the handler's threads; a
        distributed engine's followers get the stop header and are joined
        (RuntimeError if one failed)."""
        if self._loop_thread is not None:
            self._stop_event.set()
            self._loop_thread.join(timeout=10)
            self._loop_thread = None
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._response_handler.shutdown()
        close = getattr(self.engine, "close", None)
        if close is not None:
            close()

    def run_until_complete(self) -> None:
        """Drain all scheduled work (offline batch mode)."""
        # Let the handling threads finish tokenizing and enqueueing first.
        self._pool.shutdown(wait=True)
        self._pool = ThreadPoolExecutor(
            max_workers=self.options.num_handling_threads, thread_name_prefix="handler"
        )
        self.scheduler.run_until_complete()
