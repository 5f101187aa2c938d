"""SpeculativeEngine — draft/target speculative decoding
(counterpart of scalellm_tpu/speculative/speculative_engine.py).

Composes a target LLMEngine and a draft LLMEngine that share one
BlockManager (slot ids map 1:1 across both paged KV caches). A step with a
prefill chunk runs without speculation: the draft only builds its KV for the
step's tokens (no sample), then the target runs its normal step. A
decode-only step runs one speculative round (spec_executor.py): k draft
steps, the target's verify forward over the k+1 candidate positions and the
rejection sampler, on the device in one CUDA graph with graphs on; the host
then appends the drafts, commits both caches' KV and keeps the accepted
prefix (Sequence.validate_tokens).

Deliberate differences from the reference:
  - In a step with a prefill chunk the draft builds its KV for at most the
    target's chunk of each sequence (the reference builds every uncached
    token of the draft's), so that the draft's step falls in the target's
    token bucket; a decode sequence's lag of the draft behind the target is
    caught up at the next round, as the reference catches it up.
  - The draft engine runs on the target's device, with the target's CUDA
    graph option, warmup mode and serving envelope (the reference's draft
    compiles its programs on first use).
"""

from __future__ import annotations

import logging
import time

from scalellm_tpu_torch.engine.batch import Batch
from scalellm_tpu_torch.engine.llm_engine import EngineOptions, LLMEngine
from scalellm_tpu_torch.model_loader.loader import HFModelLoader
from scalellm_tpu_torch.request.sequence import EngineType
from scalellm_tpu_torch.speculative.spec_executor import SpecExecutor, round_arrays
from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS

logger = logging.getLogger(__name__)


def slot_bytes(model_path: str) -> int:
    """Bytes a KV slot of the model at `model_path` takes across its layers
    as the port lays it out (models' kv_cache_shape and kv_cache_dtype: a
    dense model's [L, P, page, 2 Hkv, D] in its dtype), from a model on the
    meta device (no weights are read)."""
    import scalellm_tpu_torch.models  # noqa: F401  (registers the models)
    from scalellm_tpu_torch.models.registry import ModelRegistry

    args = HFModelLoader(model_path).model_args
    factory = ModelRegistry.get_causal_lm_factory(args.model_type)
    if factory is None:
        raise ValueError(f"no causal LM for {args.model_type!r}")
    model = factory(args, device="meta")
    shape = model.kv_cache_shape(1, 1)
    return shape[0] * shape[-2] * shape[-1] * model.kv_cache_dtype().itemsize


class SpeculativeEngine:
    def __init__(self, options: EngineOptions):
        if not options.draft_model_path:
            raise ValueError("draft_model_path required")
        if options.num_speculative_tokens <= 0:
            raise ValueError("num_speculative_tokens must be positive")
        self.options = options
        self.k = options.num_speculative_tokens

        draft_args = HFModelLoader(options.draft_model_path).model_args
        target = LLMEngine(options, extra_kv_slot_bytes=slot_bytes(options.draft_model_path))
        if draft_args.vocab_size != target.model_args.vocab_size:
            raise ValueError(f"draft vocab {draft_args.vocab_size} != target vocab {target.model_args.vocab_size}")
        draft_options = EngineOptions(
            model_path=options.draft_model_path,
            device=options.device,
            block_size=options.block_size,
            enable_prefix_cache=options.enable_prefix_cache,
            enable_cuda_graph=options.enable_cuda_graph,
            warmup_mode=options.warmup_mode,
            max_tokens_per_batch=options.max_tokens_per_batch,
            max_seqs_per_batch=options.max_seqs_per_batch,
            max_context_len=options.max_context_len or target.model_args.max_position_embeddings,
        )
        self.target = target
        self.draft = LLMEngine(draft_options, shared_block_manager=target.block_manager)
        self.spec_executor = SpecExecutor(target.executor, self.draft.executor, self.k)
        # The scheduler's surface (as LLMEngine's).
        self.tokenizer = target.tokenizer
        self.model_args = target.model_args
        self.block_manager = target.block_manager
        self._step_counter = 0

    # ------------------------------------------------------------------ step

    def execute_model(self, batch: Batch) -> None:
        if not batch.entries:
            return
        self._step_counter += 1
        seqs = [e.seq for e in batch.entries]
        is_decode = all(e.num_tokens == 1 and e.seq.num_kv_cache_tokens(EngineType.LLM) > 0
                        for e in batch.entries)
        if not is_decode:
            # A step with a prefill chunk: the draft builds its KV for the
            # step's chunks, then the target runs its step (and samples).
            t0 = time.monotonic()
            self._build_draft_kv(batch)
            HISTOGRAMS.observe("draft_execution_latency_seconds", time.monotonic() - t0)
            t0 = time.monotonic()
            for seq in seqs:
                seq.engine_type = EngineType.LLM
            self.target.execute_model(batch)
            HISTOGRAMS.observe("target_execution_latency_seconds", time.monotonic() - t0)
            return
        self._execute_speculative(batch, seqs)

    def _build_draft_kv(self, batch: Batch) -> None:
        """Run the draft over each sequence's uncached tokens, up to where
        the target's KV reaches after this step, without sampling."""
        b = Batch()
        for e in batch.entries:
            seq = e.seq
            target_end = seq.num_kv_cache_tokens(EngineType.LLM) + e.num_tokens
            seq.engine_type = EngineType.SSM
            n = min(seq.num_tokens, target_end) - seq.num_kv_cache_tokens(EngineType.SSM)
            if n > 0:
                b.add(seq, min(n, e.num_tokens))
                b.entries[-1].needs_sample = False
        if b.entries:
            self.draft.execute_model(b)
        for e in batch.entries:
            e.seq.engine_type = EngineType.LLM

    def _execute_speculative(self, batch: Batch, seqs) -> None:
        k = self.k
        # A sequence whose target KV lags by other than one token (resumed
        # after preemption mid-round): a plain target step instead.
        if any(seq.num_tokens - seq.num_kv_cache_tokens(EngineType.LLM) != 1 for seq in seqs):
            logger.debug("irregular KV lag; a plain target step instead of a round")
            for seq in seqs:
                seq.engine_type = EngineType.LLM
            self.target.execute_model(batch)
            return
        # The round's first draft step processes the last token: the draft's
        # KV must reach the one before it.
        catch_up = Batch()
        for seq in seqs:
            lag = seq.num_tokens - 1 - seq.num_kv_cache_tokens(EngineType.SSM)
            if lag > 0:
                seq.engine_type = EngineType.SSM
                catch_up.add(seq, lag)
                catch_up.entries[-1].needs_sample = False
        if catch_up.entries:
            self.draft.execute_model(catch_up)
        for seq in seqs:
            seq.engine_type = EngineType.LLM

        arrays, S, MAXP = round_arrays(seqs, k, self._step_counter)
        t0 = time.monotonic()
        accepted, draft_ids = self.spec_executor.execute(arrays, S, MAXP)
        HISTOGRAMS.observe("target_execution_latency_seconds", time.monotonic() - t0)

        # Write back (the reference's process_validate_output).
        num_accepted = 0
        for s, seq in enumerate(seqs):
            for i in range(k):
                seq.append_token(int(draft_ids[s, i]))
            seq.commit_kv_cache(k, EngineType.SSM)
            seq.commit_kv_cache(k + 1, EngineType.LLM)
            num_accepted += seq.validate_tokens(accepted[s].tolist())
        COUNTERS.inc("num_accepted_tokens_total", num_accepted)
        COUNTERS.inc("num_draft_tokens_total", len(seqs) * k)
