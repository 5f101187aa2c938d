"""LLMEngine — owns the model executor, tokenizer and KV block manager
(counterpart of scalellm_tpu/engine/llm_engine.py).

Init: apply the model-args overrides to the checkpoint's ModelArgs
(utils/args_override.py; the list applied is applied_model_args_overrides)
-> load the model onto the device (a quantized checkpoint as it is; a
dense one quantized on the device when `quantize` asks; kv_cache_dtype
"int8" gives it int8 KV pages) -> with lora_modules, load the LoRA adapters
onto it (lora/; not on MoE or MLA models, as in the reference) -> size the
KV cache from the device memory that is free once the weights and adapters
are in place (an int8 slot is one byte an element) -> allocate blocks ->
with host_swap_bytes, the KV swapper of preemption (memory/kv_swap.py) ->
with CUDA graphs on, size the step buffer for the serving envelope and
capture the warmup buckets
(engine/executor.py), with num_decode_steps > 1 the multi-step graphs of the
decode buckets too.

For speculative decoding (speculative/) a target engine is built with
extra_kv_slot_bytes, the draft's KV bytes a slot, which its KV sizing
counts beside its own, and the draft engine with the target's BlockManager
(shared_block_manager): slot ids map 1:1 across both caches.

A step runs synchronously (execute_model; a batch that scores its prompt
takes the executor's eager score step), as N decode micro-steps in one
dispatch (execute_model_multi), or split in two for async stepping:
dispatch_model enqueues it and returns, finalize_model waits for its outputs
alone and resolves its pending tokens. With adapters, every kind of step
carries each sequence's adapter slot (ModelInputs.lora_ids).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import torch

from scalellm_tpu_torch.engine.batch import Batch
from scalellm_tpu_torch.engine.executor import WARMUP_MODES, Executor, HostOutputs
from scalellm_tpu_torch.memory.block_manager import BlockManager, BlockManagerOptions
from scalellm_tpu_torch.model_loader.loader import HFModelLoader
from scalellm_tpu_torch.models.registry import ModelRegistry
from scalellm_tpu_torch.tokenizer.tokenizer import load_tokenizer
from scalellm_tpu_torch.utils.args_override import apply_overrides

logger = logging.getLogger(__name__)

KV_CACHE_DTYPES = ("auto", "int8")


@dataclass
class EngineOptions:
    model_path: str = ""
    # "cuda", "cuda:N" or "cpu"
    device: str = "cuda"
    block_size: int = 16
    # Max KV cache size in bytes (0 = use memory utilization instead).
    max_cache_size: int = 0
    # Fraction of free device memory for KV.
    max_memory_utilization: float = 0.9
    enable_prefix_cache: bool = True
    # Direct override for the number of KV blocks (tests / CPU).
    num_blocks: int = 0
    max_top_logprobs: int = 20
    # Runtime weight quantization of a dense checkpoint: "", "int4" or "int8"
    # (group size 128, symmetric).
    quantize: str = ""
    # Quantize the lm_head at load: False, True (int8) or "int4". Takes
    # effect on a quantized model only (a quantized checkpoint, or `quantize`).
    quantize_lm_head: "bool | str" = False
    # Serve each step bucket through a CUDA graph captured once (the CPU
    # keeps the same buckets and runs them eagerly); off: every step eager.
    enable_cuda_graph: bool = True
    # Buckets captured at init: "off", "fast" (2 decode buckets) or "full"
    # (every bucket of the serving envelope below).
    warmup_mode: str = "fast"
    # Serving envelope: sizes the step buffer and the "full" warmup.
    max_tokens_per_batch: int = 512
    max_seqs_per_batch: int = 128
    max_context_len: int = 0  # 0 = the model's max_position_embeddings
    # Decode micro-steps a multi-step dispatch runs (the scheduler's
    # num_decode_steps): warmup also captures their graphs.
    num_decode_steps: int = 1
    # "auto" (the model's dtype) or "int8": int8 KV pages with per-layer
    # scales (DeepSeek's latent pages: the static ModelArgs.kv_scale).
    kv_cache_dtype: str = "auto"
    # Host memory for the KV pages of preempted sequences (0: off; a
    # preempted sequence then re-prefills).
    host_swap_bytes: int = 0
    # Speculative decoding (speculative/): a draft model checkpoint, and the
    # tokens a round proposes (k > 0 without a draft: prompt lookup).
    draft_model_path: str = ""
    num_speculative_tokens: int = 0
    # Multi-LoRA: {adapter name: HF PEFT adapter directory} (lora/).
    lora_modules: "dict | None" = None
    # `path=value` overrides applied to the loaded ModelArgs (dotted paths
    # reach QuantArgs etc: "quant_args.bits=8", "rope_theta=1e6").
    model_args_overrides: "list | None" = None


class LLMEngine:
    def __init__(self, options: EngineOptions, extra_kv_slot_bytes: int = 0, shared_block_manager=None):
        import scalellm_tpu_torch.models  # noqa: F401  (registers the models)

        self.options = options
        self._extra_kv_slot_bytes = extra_kv_slot_bytes
        self.device = torch.device(options.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for and CUDA is not available")
        t0 = time.monotonic()
        loader = HFModelLoader(options.model_path)
        self.model_args = loader.model_args
        self.tokenizer_args = loader.tokenizer_args
        self.tokenizer = load_tokenizer(options.model_path, loader.tokenizer_args.chat_template)
        factory = ModelRegistry.get_causal_lm_factory(self.model_args.model_type)
        if factory is None:
            raise ValueError(f"no causal LM for {self.model_args.model_type!r}")
        if options.warmup_mode not in WARMUP_MODES:
            raise ValueError(f"warmup_mode must be one of {WARMUP_MODES}, got {options.warmup_mode!r}")
        if options.quantize not in ("", "int4", "int8"):
            raise ValueError(f"quantize must be '', 'int4' or 'int8', got {options.quantize!r}")
        if options.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of {KV_CACHE_DTYPES}, got {options.kv_cache_dtype!r}")
        if options.kv_cache_dtype != "auto":
            self.model_args.kv_cache_dtype = options.kv_cache_dtype
        if options.quantize_lm_head and self.model_args.quant_args:
            self.model_args.quant_args.quantize_lm_head = True
        # Applied after the checkpoint's config, so the override wins.
        self.applied_model_args_overrides = apply_overrides(self.model_args, options.model_args_overrides or [])
        self.model = loader.load_model(factory(self.model_args, device="meta"), self.device)
        if options.quantize and not self.model_args.quant_args:
            from scalellm_tpu_torch.config import QuantArgs
            from scalellm_tpu_torch.quantization.runtime import quantize_model

            qargs = QuantArgs(
                quant_method="internal",
                bits=4 if options.quantize == "int4" else 8,
                group_size=128,
                quantize_lm_head=options.quantize_lm_head,
            )
            self.model = quantize_model(self.model, qargs)
            self.model_args = self.model.args
            logger.info("runtime-quantized dense checkpoint to %s", options.quantize)
        self.lora_meta = None
        if options.lora_modules:
            self._load_lora(options.lora_modules)
        self.executor = Executor(self.model, self.device, options.max_top_logprobs)
        logger.info(
            "model %s loaded in %.1fs", self.model_args.model_type, time.monotonic() - t0
        )

        if shared_block_manager is not None:
            num_blocks = shared_block_manager.options.num_blocks
            self.block_manager = shared_block_manager
        else:
            num_blocks = options.num_blocks or self._profile_num_blocks()
            self.block_manager = BlockManager(
                BlockManagerOptions(
                    num_blocks=num_blocks,
                    block_size=options.block_size,
                    enable_prefix_cache=options.enable_prefix_cache,
                )
            )
        self.executor.init_kv_cache(num_blocks, options.block_size)
        self.kv_swapper = None
        if options.host_swap_bytes > 0:
            from scalellm_tpu_torch.memory.kv_swap import HostKVPool, KVSwapper

            self.kv_swapper = KVSwapper(self.executor, self.block_manager, options.block_size,
                                        HostKVPool(options.host_swap_bytes))
        logger.info(
            "kv cache: %d blocks x %d slots (%.2f GiB)", num_blocks, options.block_size,
            self.executor.kv_cache_bytes(num_blocks, options.block_size) / 2**30,
        )
        if options.enable_cuda_graph:
            envelope = dict(
                max_tokens=options.max_tokens_per_batch, max_seqs=options.max_seqs_per_batch,
                max_context_len=options.max_context_len or self.model_args.max_position_embeddings)
            self.executor.init_graphs(options.block_size, **envelope)
            self.executor.warmup(options.block_size, options.warmup_mode, multi_steps=options.num_decode_steps,
                                 **envelope)
        self._step_counter = 0

    def _load_lora(self, modules: dict) -> None:
        """Load the adapters onto the model's device, before the KV cache
        is sized from what is left free (the reference's rules and words)."""
        from scalellm_tpu_torch.lora import load_lora_adapters

        if self.model_args.n_experts > 0:
            raise ValueError("LoRA on MoE models is not supported")
        if not hasattr(self.model, "lora_meta"):
            raise ValueError(f"model family {self.model_args.model_type!r} does not support LoRA adapters")
        stacks, meta = load_lora_adapters(modules, self.model)
        self.model.set_lora(meta, stacks)
        self.lora_meta = meta
        logger.info("loaded %d LoRA adapter(s): %s", len(meta.names), meta.names)

    def kv_cache_slot_size_in_bytes(self) -> int:
        """Bytes per KV slot across all layers (one an element of int8
        pages)."""
        shape = self.model.kv_cache_shape(1, 1)  # [L, 1, 1, 2*Hkv, Dh] or [L, 1, 1, 1, Dc]
        return shape[0] * shape[-2] * shape[-1] * self.model.kv_cache_dtype().itemsize

    def _profile_num_blocks(self) -> int:
        """Size the KV cache from the device's free memory (the CPU keeps a
        256 MiB default); a block holds a slot of this model's KV and
        extra_kv_slot_bytes (a draft's)."""
        opts = self.options
        block_bytes = (self.kv_cache_slot_size_in_bytes() + self._extra_kv_slot_bytes) * opts.block_size
        if opts.max_cache_size > 0:
            cache_bytes = opts.max_cache_size
        elif self.device.type == "cuda":
            torch.cuda.empty_cache()
            free, _ = torch.cuda.mem_get_info(self.device)
            cache_bytes = int(free * opts.max_memory_utilization)
        else:
            cache_bytes = 256 * 2**20
        return int(max(cache_bytes // block_bytes, 16))

    def _prepare(self, batch: Batch):
        self._step_counter += 1
        mi, si, _ = batch.prepare_model_inputs(self.options.block_size, self._step_counter,
                                               vocab_size=self.model_args.vocab_size)
        if self.lora_meta is not None:
            mi.lora_ids = batch.lora_slots
        want_lp = any(e.seq.sampling_params.logprobs for e in batch.entries)
        return mi, si, want_lp

    def execute_model(self, batch: Batch) -> None:
        """Run one engine step for the batch and write its samples back."""
        if not batch.entries:
            return
        mi, si, want_lp = self._prepare(batch)
        if batch.score_top_k is not None:
            outs, scores = self.executor.execute_score(mi, si, batch.score_targets, batch.score_top_k)
            batch.process_prompt_scores(*(x.cpu().numpy() for x in scores), self.tokenizer)
        else:
            outs = self.executor.execute(mi, si, decode_only=batch.is_decode_only)
        o = HostOutputs(outs, want_lp).wait()
        batch.process_sample_output(o["next_tokens"], o["logprobs"], o["top_ids"], o["top_logprobs"],
                                    self.tokenizer)

    # -------------------------------------------------------- multi-step

    @property
    def supports_multi_step(self) -> bool:
        """Multi-step decode: N micro-steps a dispatch, tokens fed back on
        the device (one device, one driving process)."""
        return True

    def execute_model_multi(self, batch: Batch, num_steps: int) -> None:
        """Run `num_steps` decode micro-steps in one dispatch (one graph
        replay with graphs on): one host round trip and one batch prep per N
        tokens. The scheduler reserves N KV slots a sequence and gates on
        Batch.can_multi_step; samples after a sequence finishes mid-window
        are dropped on the host (their KV writes land in the sequence's own
        reserved slots or the padding page, Executor._multi_steps)."""
        mi, si, want_lp = self._prepare(batch)
        outs = self.executor.execute_multi(mi, si, num_steps, self.options.block_size)
        o = HostOutputs(outs, want_lp).wait()
        batch.process_multi_sample_output(o["next_tokens"], o["logprobs"], o["top_ids"], o["top_logprobs"],
                                          self.tokenizer)

    # ------------------------------------------------------------- async step

    @property
    def supports_async(self) -> bool:
        """Async stepping (dispatch_model / finalize_model): one process
        drives the device, so the previous step's samples can be merged on
        it."""
        return True

    def dispatch_model(self, batch: Batch, prev_outs: "HostOutputs | None" = None) -> HostOutputs:
        """Enqueue one step without waiting for its results. Its samples
        are appended as pending placeholders (Sequence.append_pending_token);
        rows whose input token is the previous step's sample are merged on
        the device from `prev_outs.outs.next_tokens`. Pair with
        finalize_model once the next step has been dispatched."""
        mi, si, want_lp = self._prepare(batch)
        pending = None
        if batch.pending_fix is not None:
            pending = (*batch.pending_fix, prev_outs.outs.next_tokens)
        outs = self.executor.execute(mi, si, decode_only=batch.is_decode_only, pending=pending)
        fetched = HostOutputs(outs, want_lp)
        batch.append_pending_tokens()
        return fetched

    def finalize_model(self, batch: Batch, fetched: HostOutputs) -> None:
        """Wait for a dispatched step's outputs (its own copy, not the steps
        enqueued after it) and resolve its pending tokens."""
        o = fetched.wait()
        batch.resolve_sample_output(o["next_tokens"], o["logprobs"], o["top_ids"], o["top_logprobs"],
                                    self.tokenizer)
