"""LLM — synchronous offline batch inference
(counterpart of scalellm_tpu/llm.py).

generate(prompts, sampling_params) schedules the whole batch, then drains
the scheduler with run_until_complete. Chunked prefill is off by default (a
huge max_tokens_per_batch), as in the reference package, CUDA graphs are on
(one per step bucket, the two "fast" warmup buckets captured at init) and so
is async scheduling (one step in flight); num_decode_steps > 1 runs that many
decode micro-steps a dispatch. lora_modules ({name: HF PEFT adapter
directory}) loads LoRA adapters, and generate's `lora` picks them by name;
model_args_overrides (`path=value` strings) changes the checkpoint's
ModelArgs before the model is built.
The model runs on the CUDA device unless `devices` names another ("cpu" in
the tests).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions
from scalellm_tpu_torch.request.output import Priority, RequestOutput
from scalellm_tpu_torch.sampling.params import SamplingParams


class LLM:
    def __init__(
        self,
        model: str,
        devices: str = "auto",
        block_size: int = 16,
        max_cache_size: int = 0,
        max_memory_utilization: float = 0.9,
        enable_prefix_cache: bool = True,
        enable_cuda_graph: bool = True,
        max_tokens_per_batch: int = 409600,  # chunked prefill off by default
        max_seqs_per_batch: int = 2048,
        num_speculative_tokens: int = 0,
        num_handling_threads: int = 4,
        draft_model: Optional[str] = None,
        tp_size: int = 1,
        num_blocks: int = 0,
        kv_cache_dtype: str = "auto",
        quantize: str = "",
        quantize_lm_head: "bool | str" = False,
        host_swap_bytes: int = 0,
        enable_async_scheduling: bool = True,
        num_decode_steps: int = 1,
        lora_modules=None,
        model_args_overrides=None,
    ) -> None:
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
            num_blocks=num_blocks,
            kv_cache_dtype=kv_cache_dtype,
            quantize=quantize,
            quantize_lm_head=quantize_lm_head,
            host_swap_bytes=host_swap_bytes,
            enable_async_scheduling=enable_async_scheduling,
            num_decode_steps=num_decode_steps,
            lora_modules=lora_modules,
            model_args_overrides=model_args_overrides,
        )
        self._handler = LLMHandler(options)

    def generate(
        self,
        prompts: Union[str, Sequence[str]],
        sampling_params: Union[SamplingParams, Sequence[SamplingParams], None] = None,
        priority: Priority = Priority.NORMAL,
        lora: "str | Sequence[str] | None" = None,
    ) -> List[RequestOutput]:
        """Generate for every prompt; `lora` names the LoRA adapter of all
        prompts, or one name (or None: the base model) a prompt."""
        if isinstance(prompts, str):
            prompts = [prompts]
        if sampling_params is None:
            sampling_params = SamplingParams()
        if isinstance(sampling_params, SamplingParams):
            sps = [sampling_params] * len(prompts)
        else:
            if len(sampling_params) != len(prompts):
                raise ValueError("one SamplingParams per prompt, or one for all")
            sps = list(sampling_params)

        outputs: List[Optional[RequestOutput]] = [None] * len(prompts)
        done = threading.Event()
        remaining = [len(prompts)]
        lock = threading.Lock()

        def make_cb(i):
            def cb(out: RequestOutput) -> bool:
                out.prompt = prompts[i]
                outputs[i] = out
                if out.finished:
                    with lock:
                        remaining[0] -= 1
                        if remaining[0] == 0:
                            done.set()
                return True

            return cb

        loras = [lora] * len(prompts) if lora is None or isinstance(lora, str) else list(lora)
        if len(loras) != len(prompts):
            raise ValueError("one LoRA adapter name per prompt, or one for all")
        for i, (p, sp) in enumerate(zip(prompts, sps)):
            self._handler.schedule_async(p, sp, priority, False, make_cb(i), lora=loras[i])
        self._handler.run_until_complete()
        done.wait(timeout=60)
        return [o for o in outputs if o is not None]

    def encode(self, text: str) -> List[int]:
        return self._handler.encode(text)

    def decode(self, tokens: Sequence[int]) -> str:
        return self._handler.decode(tokens)

    def apply_chat_template(self, messages) -> str:
        return self._handler.apply_chat_template(messages)

    def close(self) -> None:
        """Stop the handler's threads, drop the engine and give its device
        memory (weights, KV cache, graph pools) back to the device. The
        caching allocator keeps freed blocks for reuse; left there, the next
        engine's first allocations are carved out of the freed KV cache's
        block, which then can never be returned, and that engine sizes its
        own KV cache from what the device reports free beside it."""
        import gc

        import torch

        self._handler.stop()
        self._handler = None
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
