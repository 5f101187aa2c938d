#!/usr/bin/env python3
"""On-card smoke test of scalellm_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build: every CUDA kernel of the serving paths, from csrc/ with nvcc
     (one nvcc per source, started together).
  3. kernels: each kernel against its plain PyTorch version on the card,
     with CUDA-event timings of the kernel, the plain version and a library
     yardstick (L2 flushed by reading 128 MB before each call), beside the
     least time the card could take (bytes over
     3.35 TB/s, operations over 989 TFLOP/s bf16 or 1979 TOP/s int8).
     a. ragged paged attention (K1) in bf16 at seven shapes of the serving
        paths: decode batches, whose every sequence takes the split-KV
        blocks ((a) and (c), 8 decodes; (f) one sequence of 8192 tokens;
        (g) 64 decodes of 128-2048 tokens; (h) 8 decodes at Qwen2-MoE's
        heads, GQA group 1, head dim 128; at head dim 256, (j) 8 decodes
        at Gemma-2-9B's heads (16 over 8, soft cap 50), (l) 8 at
        Gemma-2B's (8 over 1) and (m) one of 8192 tokens), and the mixed
        T = 512 batches (b), (d), (e), (i) (Qwen2-MoE's heads), (k)
        (Gemma-2-9B's heads, window 128, soft cap 50), whose chunks take
        the q-tiled tensor-core blocks and
        whose decodes the split blocks; then 8 decodes and the mixed batch
        each with ALiBi at MPT-7B's heads ((n), (o): 32 over 32, head dim
        128), at Phi-2's head dim 80 ((p), (q)) and in float32 at GPT-2's
        heads ((r), (s): 12 over 12, head dim 64, K1's f32 kernel); then
        over int8 pages (KV_INT8_SCALES) 8 decodes and the mixed batch at
        Llama-3.1-8B's heads ((t), (u)), 8 decodes with ALiBi at MPT-7B's
        heads ((v)) and 8 decodes in f32 at GPT-2's ((w))
        (yardstick: scaled_dot_product_attention on gathered K/V, with an
        additive float mask for ALiBi, in f32 for (r), (s) and (w), on pages
        dequantized ahead of time for (t)-(w)). Each is held
        against the plain version within KERNEL_TOL (f32: F32_TOL) and, row
        by row, within ATTENTION_REL_TOL of the row's size; on each bf16
        decode batch that row check must fail the plain split-and-merge with
        one piece left out;
     b. the quantized matmuls at the five Llama-3.1-8B projection shapes:
        w4a8 at M = 1, 8, 16, 64, dequant and group at M = 512 (dequant at
        gate_up also at M = 128 and 256), dequant and group with the RMSNorm
        in their prologue at (K, N) = (2048, 2560), M = 128, and dequant at
        the DeepSeek-V2-Lite shared experts' down projection as phase 7
        quantizes it (K = 2816, N = 2048, G = 32, bf16 scales) at its decode
        M = 16 (yardstick: one bf16 matmul on weights dequantized ahead of
        time); per M = 512 shape the bytes the chosen tiles move through L2;
        per shape at M = 16 the device time of w4a8's pre-pass and of its
        main grid (torch.profiler), and w4a8's floor: one block of rows.
     c. the DeepSeek-V2-Lite kernels: the grouped GEMM (K6) at the decode
        (96 rows: 8 tokens and 8 padding rows x 6 experts, routed by a
        seeded softmax over 64 experts, the padding rows all to the same 6)
        and prefill (3072 rows) steps, for gate/up (2048 -> 1408) and down
        (1408 -> 2048) (yardstick: torch._grouped_mm where the build has it,
        else a loop of torch.matmul over the experts with rows), and each
        with both block shapes (weight rows x tokens: 64 x 16 and 128 x
        64); the same at Mixtral-8x7B's experts (8, top-2, 4096 <-> 14336:
        32 and 1024 rows) and Qwen1.5-MoE-A2.7B's (60, top-4, 2048 <->
        1408: 64 and 2048 rows); the int4 expert dequantization that feeds
        K6 in phases 7 and 8, at V2-Lite's two projections (64 experts,
        group 128) and Mixtral's (8 experts), bit
        for bit against its plain version, beside the PyTorch form it
        replaced; the MLA decode kernel
        (K9) at 8 sequences of 16-600 tokens, one of 8192 tokens and 64 of
        128-2048 tokens (split-KV), and the MLA prefill kernel (K10) on a
        mixed T = 512, S = 8 batch, both also over int8 latent pages
        (LATENT_INT8_SCALE) at the 8-decode and the mixed batch, 16 heads
        over the 576-wide latent cache
        (yardstick: scaled_dot_product_attention on gathered rows); each
        held against its plain version within KERNEL_TOL and row by row
        within ATTENTION_REL_TOL, the decode batches' row check shown to
        fail the plain split-and-merge with one piece left out, and each
        call's device time split between the attention grid and its merge
        (torch.profiler).
     d. the routed quantized-expert kernels at DeepSeek-V2-Lite's widths:
        K8 (gate and up, 2048 -> 1408, one launch) and K7 (down, 1408 ->
        2048), int4 at group 128 and int8, at the decode step of 3c (96
        rows, the padding rows sharing their experts) and in the T=1 layout
        (one token over 8 rows, 6 experts, starts given), then int4 at
        Qwen1.5-MoE-A2.7B's decode step (60 experts, top-4, 64 rows; down's
        11 groups of 128); bound: the active
        experts' weight and scale bytes (yardstick: torch._grouped_mm on
        weights dequantized ahead of time); each with the rate at which it
        reads those bytes and the stream probe's (K12c) on as many.
     e. the small-M variants gemv (K12a) and w4a8g (K12b) at the phase-3b
        Llama-3.1-8B shapes (o also asymmetric) at M = 1, 16, 64, beside K2,
        K3 and the bf16 matmul; the stream probe (K12c) at the same shapes,
        equal to its plain version, failing if it reads faster than 3.35
        TB/s; the fused quantized MLP (K11) at Llama-3.1-8B's MLP (int4,
        G = 128, bf16 scales, symmetric and asymmetric) at M = 1, 8, 16,
        32, 64, beside the two-launch path (K2 gate_up, silu * up, K2 down)
        and two bf16 matmuls; each gemv and K11 line with the rate at which
        it reads the weights; then K11's own path, its entry point
        quant_mlp at M = 1, 8, 16, 32, 64 (no model calls it, as in the
        reference).
  Phases 4-7 serve each model four times (phases 8 and 9 twice: async with
  graphs, then eager), on fresh engines in the same
  call: three times with CUDA graphs (every engine step replays the graph
  of its bucket, the "full" warmup captures every bucket of the serving
  envelope at init, SERVE_ENVELOPE): "sync", one step at a time; "async",
  the default, one step in flight with its
  pending tokens merged on the card; "ms4", num_decode_steps=4, where a
  decode-only batch runs 4 micro-steps in one graph replay (the warmup also
  captures the 4-step graph of every decode bucket); then eagerly (sync).
  Each serve is a warm-up request, a timed generate of 8 prompts (32
  greedy tokens each) and the same traffic with other text under
  torch.profiler. The eager serve must sample the sync serve's token ids
  at every step. The async and ms4 serves need not build the same steps
  (async skips a sequence whose pending token reaches its limit; K1's and
  K9's split plans depend on the step's S and block table), so they are
  held to the sync serve request by request: the same ids, or every token
  a greedy choice up to kernel rounding (a teacher-forced prefill of prompt
  and output through the model: each generated token's logit within
  LOGITS_TOL of its position's largest); the async serve must take async
  dispatches and the ms4 serve multi-step ones, and no graph serve may
  capture a graph inside its timed generate. Each dispatch's launches are
  held exactly to what the path implies (N times a decode step's for N
  micro-steps), counted by the wrappers (an eager step, or the eager run
  and the recording of a capture) or, for a replay, as its graph's
  wrappers counted when it was recorded. Phase 4 also checks that
  finalizing an async step waits for that step alone: it returns while a
  device spin enqueued after the next step still runs. Hooks that act
  when a step's Python runs (phase 5's variant serves, the in-model probe,
  phases 6 and 7's routing replay) run on the eager engine's model.
  4. end to end, bf16: a TinyLlama-1.1B-shaped checkpoint (random weights
     from a seed) served by scalellm_tpu_torch.LLM with chunked prefill and
     the prefix cache; every request must finish and every engine step must
     go through the attention kernel once a layer. Then one prefill batch and the
     decode step after it (every sequence one token: K1's split-KV blocks)
     run through the model twice, with the kernel and with the plain
     attention, and the logits must agree.
  5. end to end, INT4: a GPTQ checkpoint of Llama-3.1-8B's widths (random
     int4 weights from a seed, group 128, symmetric) served by
     LLM(path, quantize_lm_head=True) with the same traffic. Every engine
     step must launch the attention kernel once per layer and a quantized
     matmul kernel four times per layer plus once for the lm_head: dequant
     for the projections of steps with more than 64 tokens, w4a8 otherwise.
     A short third run with variant="group" set on the model's quantized
     matmul sends the same path through the group kernel, and two more with
     variant="gemv" and "w4a8g" through K12a and K12b (exactly 4 per layer
     plus the lm_head on steps of up to 64 tokens; dequant in the layers and
     the variant in the lm_head above). Then a prefill and a decode batch
     run through the model twice, with the kernels and with the plain
     versions, and the logits must agree; the decode batch again under
     gemv and w4a8g. Last the reference's in-model probe: one decode step
     under torch.profiler with the real kernels, then with the stream probe
     (K12c) in every layer projection, and the fraction of the stream
     ceiling that the projections reach. --int4-layers N sets the depth
     (default 16 of 32: the script's time limit, since phases 8 and 9).
  6. end to end, bf16 MoE + MLA: a DeepSeek-V2-Lite checkpoint at the
     published widths (random bf16 weights from a seed, one tensor per
     expert, 16 GB on disk at 14 layers, written once for phases 6 and 7
     and removed after them) served by LLM(path) with the same traffic. Every engine
     step must launch the grouped GEMM 3 times per MoE layer, the MLA
     decode kernel once per layer on decode-only steps and the MLA prefill
     kernel once per layer on the others. Then a prefill and a decode batch
     run through the model twice, with the kernels and with the plain
     versions, the second run replaying the first one's routing, and the
     logits must agree. --deepseek-layers N sets the depth of phases 6 and
     7 (default 14 of 27: the script's time limit, since phases 8 and 9).
  7. end to end, INT4 MoE + MLA: the same checkpoint served by LLM(path,
     quantize="int4"): experts and projections quantized on the card. Every
     engine step must launch exactly what the path implies: per MoE layer
     K8 and K7 once where the step's routed rows take the decode kernel (T
     <= 32), else the expert dequantization and the grouped GEMM 3 times; K9/K10 as in phase 6; each
     quantized projection's kernel (w4a8 or dequant) as plan() picks it.
     Then the profile and the same kernel-vs-plain logits check, the
     kernels run twice: the two runs' logits must be the same bits (the MoE
     combine adds each token's rows in a fixed order, no atomics).
  8. end to end, Mixtral-8x7B at its published widths, 8 of its 32
     layers (--mixtral-layers; 23.7 GB bf16), one checkpoint written once and
     removed after: bf16, then LLM(path, quantize="int4") (int4 experts at
     G = 128: every step dequantizes the 8 experts and runs K6, the decode
     kernel's gate refusing their 58.7 MB weight ring), each served async
     with graphs (the default) and then eagerly, every request of the
     async serve getting the eager serve's ids, with phase 6/7's per-step
     launch checks (K1 once a layer in place of K9/K10), the routing-pinned
     logits check and, for INT4, the repeat's bits.
  9. the same for Qwen1.5-MoE-A2.7B at its published widths and depth (60
     experts of 1408, top-4, a shared expert of 5632 with its sigmoid gate,
     the qkv bias, MHA: K1 at GQA group 1; 28.6 GB bf16); INT4 decode steps
     take K8 and K7.
  10. the same for Gemma-2-9B at its published widths (head dim
     256: K1 at D = 256, GQA group 2, soft cap 50 on every layer, a
     4096-token window on the even layers; the post-block norms, tied
     embeddings; 16 of its 42 layers, --gemma2-layers, even, sets the depth),
     bf16 then runtime INT4 (every projection int4 at G = 128, the lm_head
     the tied bf16 embedding): every step K1 once a layer and, under INT4,
     each layer's four projections through K2 or K4 as plan() picks them.
  11. the same for Qwen3-8B at its published widths (qk norm, head dim
     128, GQA group 4; 14 of its 36 layers, --qwen3-layers sets the depth).
  12. the same for Phi-2 at its published widths (head dim 80: K1 at D =
     80, MHA; partial rotary 0.4, the parallel residual, LayerNorm and
     biases everywhere, the untied lm_head with its bias; 5.6 GB bf16 at its
     32 layers; 16 of them, --phi2-layers sets the depth), bf16 then runtime
     INT4.
  13. the same for MPT-7B (ALiBi at head dim 128, MHA; bias-free LayerNorm;
     13.3 GB bf16 at its 32 layers; 8 of them, --mpt-layers sets the
     depth), bf16 then runtime INT4.
  14. BLOOM-560m at its published widths and depth (ALiBi at head dim 64,
     the embedding LayerNorm, the per-head interleaved query_key_value,
     vocab 250880), bf16 only.
  15. GPT-2 (124M) in float32, as the reference serves its float32
     checkpoints: K1's f32 kernel and learned positions.
  Phases 10-15 draw their checkpoints by fan-in (scaled_init), norms of
  weight 1 and biases 0. Every launch check of phases 6-15 also holds K1's
  counts of its ALiBi, head-dim-80 and f32 launches to the model's layers
  (phases 12-15 must have launched each).
  16. int8 KV pages on TinyLlama-1.1B (phase 4's checkpoint and traffic):
     per-layer scales calibrated by eval/kv_calibration.py on
     tests/data/corpus.txt (the kv_scales.json sidecar), served async with
     graphs and then eagerly with kv_cache_dtype="int8" (K1 on int8 pages,
     each launch counted as such: the same ids, logits against the plain
     path), the int8 cache holding at least KV_BLOCKS_RATIO times phase 4's
     blocks in the same memory share; KV swap's page moves on its int8 cache
     (swap_direct_check); then eval/ppl.py over PPL_WINDOWS windows with
     bf16 KV, int8 KV at the default scale and int8 KV calibrated, the
     calibrated scales keeping each token's NLL at least as close to bf16
     KV's as the default scale (the reference's perplexity ratio printed:
     on random weights it is noise); then GPT-2 in float32 over int8 pages
     (K1's f32 kernel on int8 pages).
  17. DeepSeek-V2-Lite (phase 6's checkpoint and depth) with int8 latent
     pages at the static ModelArgs.kv_scale: K9/K10 on int8 pages, served
     and checked as phases 8-15.
  18. KV swap on TinyLlama: the same traffic through an engine with about
     three requests' blocks and host_swap_bytes (SWAP_POOL_BYTES) for the
     preempted ones, beside an ample-memory serve and a tight serve without
     swap: swap-outs and swap-ins must happen, each request gets the ample
     serve's ids or differs by tokens that are greedy choices up to kernel
     rounding (the request and step emitted), and swap_direct_check (pages
     fetched, restored elsewhere and fetched again byte-equal, the fetch
     and restore rates, a step graph replayed after a restore reading the
     restored pages).
  Every LLM.close() is followed by a line of the memory left on the card
  (`{tag}_closed`), and fails if the caching allocator kept more than
  CLOSED_SLACK_BYTES of the closed engine's freed blocks.
  19. speculative decoding and prompt logprobs: a Llama-2-7B target at its
     published widths and depth (13.5 GB bf16, scaled_init) with a
     TinyLlama-1.1B draft (phase 4's checkpoint), k = SPEC_K. Against the
     plain target serve of the same call, on the same prompts and greedy
     tokens: (a) the draft model's rounds with graphs (each round one
     graph replay, K1 exactly k times a draft layer and once a target layer
     as counted at its capture, none captured in the timed generate), then
     eagerly (the same ids); the tok/s of both serves, the acceptance, and
     a round's device time (its replay) split into draft, verify and
     sampler (the eager round under torch.profiler); (b) TinyLlama as its
     own draft, acceptance at least SPEC_ACCEPTANCE_MIN; (c) prompt lookup
     on prompts that repeat text, the target made to repeat its last token
     (copy_prone: its lm_head set to its embedding table) in the n-gram
     serve and in its plain serve; (d) sampled speculation (temperature 1,
     top_p 0.9, seeds) on two fresh engines, the same ids; (e) prompt
     logprobs (top 5) against a teacher-forced forward with the plain
     attention, and chunked (64-token batches) against whole. Each served
     request gets the plain serve's ids, or every differing token is a
     greedy choice up to kernel rounding (teacher_forced_gap).
  20. LoRA: two random adapters in the HF PEFT layout (LORA_ADAPTERS: "one"
     r = 16 on all seven targets, "two" r = 8 on q_proj and v_proj), the 8
     requests split across base, "one" and "two" (LORA_OF_REQUEST). bf16
     TinyLlama-1.1B at full width and depth: a base serve (async, graphs:
     what LoRA costs), then with both adapters sync with graphs, async, 4-step
     decode and eager, each on a fresh engine, K1 exactly once a layer a
     step; graphs against eager (the same ids), async and ms4 against sync
     (check_mode, each request's gaps through its own adapter); a checkpoint
     merged offline with "one" (W + B A alpha / r, bf16) gives each "one"
     request the runtime adapter's ids or greedy choices of the LoRA model
     up to kernel rounding; one prefill and one decode batch with all three
     slots through the kernels and the plain attention within LOGITS_TOL,
     and "one" moving the logits from the base's (LORA_MOVE_MIN). Then the
     GPTQ Llama-3.1-8B of phase 5's depth with both adapters, sync with
     graphs and eager beside the base serve: the same ids, the quantized
     kernels exactly 4 layers + 1 a step, no quantized matmul given the
     RMSNorm prologue, kernels against every plain version within
     LOGITS_TOL. The `lora_cost` line: tok/s and TTFT of the LoRA serves
     beside the base serves, and the adapters' bytes.
  21. guided decoding, tool calls and AsyncLLMEngine: TinyLlama-1.1B at
     full width and depth (bf16, seed 0) with a tokenizer of 32000 ids
     (guided_tokenizer_json: the char tokens and multi-character ones), 8
     greedy requests (GUIDED_REQUESTS: two unconstrained, a forced call of
     GUIDED_TOOL under the chat template, two choices, a regex,
     GUIDED_SCHEMA, json_object) served with graphs (sync) beside an
     unconstrained serve on the same engine, then eagerly: K1 exactly once
     a layer a step, the same ids with graphs and without, each output in
     its constraint's language (whole and parsed where it ended), and at
     each guided request's first decode step the kernel path's masked
     greedy choice the plain path's up to LOGITS_TOL; the vocabulary's
     bytes and the schema's FSM (built, cached, first row) timed, and
     Batch.prepare_model_inputs' host ms with and without guided rows. Then
     AsyncLLMEngine on a fresh engine, stepping on its loop thread: 8
     streamed requests at once (two chat requests with the tool), each
     stream's deltas its final text, one stream cancelled and its blocks
     returned, every await under a deadline, no failed step logged, K1
     once a layer a step, TTFT per request from its first item, and stop()
     giving the memory back.
  22. the servers: TinyLlama-1.1B at full width and depth (bf16, seed 0,
     phase 4's char tokenizer) in an AsyncLLMEngine built from
     serve/api_server.py's flags as the CLI builds it (graphs, async
     stepping, the "full" warmup), served by ApiServer on its own thread's
     event loop on a free port of 127.0.0.1, its clients urllib threads of
     this process. /health, /v1/models, /config and two invalid bodies
     (SERVER_REFUSALS: the JAX package's statuses and messages); pass 1,
     phase 4's 8 prompts one at a time through /v1/completions, each text
     the one the same engine gives the prompt alone through
     AsyncLLMEngine.schedule_async, and /metrics grown by its 8 requests;
     pass 2, 8 clients at once (server_traffic: 4 completions, 4 chat
     completions, 2 of each streamed, the last a forced call of GUIDED_TOOL
     through tool_choice), three times: through the server with the tool
     call's constraint compiled inside the pass (its first use), the same 8
     requests straight to the engine, and through the server again with
     the constraint cached: each unconstrained request's ids pass 1's (or
     the straight pass's for a chat) or greedy choices up to kernel
     rounding, each stream's deltas its text with one finish reason, the
     call parsed as JSON of the tool's schema with finish_reason
     "tool_calls"; every pass with K1 once a layer a step and no graph
     captured, its client-side and engine TTFT and tok/s, the device's idle
     share of the warm pass from a profiled repeat; /profile/start
     and /profile/stop around two requests, the trace naming K1's kernel;
     pass 1's prompts through the port's gRPC server on the same engine
     and one through the port's gateway in front of it, the same texts;
     then the CLI (python3 -m scalellm_tpu_torch.serve.api_server) in a
     process of its own: /health within CLI_READY_S, pass 1's text for a
     prompt, exit 0 within CLI_STOP_S of SIGTERM.
  23. tensor parallelism (engine/distributed.py): two ranks on the one
     card over gloo (TP_DEVICES; NCCL refuses two ranks on one device),
     each a process, serving phase 4's traffic synchronously and eagerly
     (tp_serve), every dispatch's launches on rank 0 held to
     moe_step_launches and every rank's read back (rank_launches) and held
     equal to rank 0's, against the tp 1 serve of the same checkpoint in
     the same call (tp_compare: the same ids, or tp 2's differing tokens
     within LOGITS_TOL of the tp 1 model's largest logit; the first step's
     and the first decode step's logits within LOGITS_TOL). (a) INT4
     Llama-3.1-8B on phase 5's GPTQ checkpoint at phase 5's depth (kept for
     it), each rank launching K1, K2, K4 and K5 at its shapes; (b)
     TinyLlama-1.1B, full width and depth, bf16, at tp 2 without and with
     sequence parallelism, each held to tp 1 and the SP serve to the other
     tp 2 serve bit for bit; (c) Mixtral-8x7B bf16 on phase 8's checkpoint while it
     exists (run inside phase 8), 4 experts a rank, K6 on each rank, the
     tp 1 serve replaying tp 2's routing with its own router's choices
     held to it (route_gaps); (d) moe_mlp_a2a across two ranks, each a
     spawned process, at Mixtral's widths against the single-rank moe_mlp
     (tp_a2a_rank); (e) (a) over NCCL, one card a rank, where the machine
     has two cards, else a line that says it did not run. Each serve's line
     carries the backend, the world size, the decode step's milliseconds
     and its share in the collectives (torch.profiler, collective_share).
  24. a line of the seconds each phase took, a `kernels` JSON line, then
     the result line.

It needs the repository (it fails in a directory that holds only this
script) and a CUDA device (it fails where torch.cuda.is_available() is
false). JSON lines carry the numbers; the card's name and power limit stand
beside every timing.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
F32_FLOPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
# Quantized matmuls against their plain versions: the integer dots are exact
# on both sides; the f32 sums run in another order and the output is rounded
# to bf16, so: 1% of the output's largest magnitude, mean error 0.1% of it.
QUANT_TOL_MAX, QUANT_TOL_MEAN = 1e-2, 1e-3
KERNEL_TOL = 2e-2  # bf16 output (8-bit mantissa) of values of magnitude <~ 3
# Ragged paged attention also per (token, head) row: its largest error over
# the row's largest |value|. A decode row of a long context is small (about
# 0.05 at 8192 rows of N(0, 1) scores), so KERNEL_TOL alone would pass a
# merge that lost one of its 16 pieces; that moves the row by ~10% of it.
ATTENTION_REL_TOL = 2e-2
# K1's f32 kernel (GPT-2) against the plain version in f32: f32 sums in
# another order (no TF32, whose 10-bit products would be off by about 1e-3).
F32_TOL = 1e-4
# int8 KV pages (phase 3a's int8 shapes): N(0, 1) K and V quantized as the
# int8 cache holds them, round(x / scale), at these static (k_scale,
# v_scale); phase 3c's int8 latent pages at DeepSeek's default scale.
KV_INT8_SCALES = (0.03, 0.05)
LATENT_INT8_SCALE = 0.0625
# Logits of the 22-layer random-weight model (std ~1): the two attentions
# round different f32 sums to bf16, and those 1-ulp differences pass through
# 22 bf16 layers.
LOGITS_TOL = 0.25
TIMED_RUNS = 20
FLUSH_BYTES = 128 * 2**20  # read before each timed call: 2.5x the 50 MB L2
SPIN_CYCLES = 1_000_000  # about 0.5 ms of device spin before each timed call
FETCH_SPIN_CYCLES = 1 << 30  # about half a second of device spin (check_fetch_overlap)
SEED = 0
DEVICE = "cuda"

# meta-llama/Llama-3.1-8B config.json (bench.py preset "llama31-8b-int4"),
# with the GPTQ quantization_config the preset stands for.
LLAMA31_8B_INT4 = dict(
    model_type="llama", architectures=["LlamaForCausalLM"], torch_dtype="bfloat16",
    hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=8, vocab_size=128256,
    max_position_embeddings=8192, rms_norm_eps=1e-5, rope_theta=500000.0,
    hidden_act="silu", tie_word_embeddings=False, bos_token_id=128000, eos_token_id=128001,
    quantization_config=dict(quant_method="gptq", bits=4, group_size=128, sym=True,
                             desc_act=False),
)
GROUP = 128

# TinyLlama/TinyLlama-1.1B-Chat-v1.0 config.json (bench.py preset
# "tinyllama-1.1b").
TINYLLAMA = dict(
    model_type="llama", architectures=["LlamaForCausalLM"], torch_dtype="bfloat16",
    hidden_size=2048, intermediate_size=5632, num_hidden_layers=22,
    num_attention_heads=32, num_key_value_heads=4, vocab_size=32000,
    max_position_embeddings=2048, rms_norm_eps=1e-5, rope_theta=10000.0,
    hidden_act="silu", tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def attention_row_rel_err(torch, got, want) -> float:
    """The worst (token, head) row's largest |got - want| over its largest
    |want|; a row the plain version leaves zero must be zero (else inf)."""
    diff = (got.float() - want.float()).abs().amax(-1)
    size = want.float().abs().amax(-1)
    return torch.where(diff == 0, 0.0, diff / size).max().item()


def dropped_piece(attention, spec, inputs):
    """(slot, piece) of a planted fault on a decode batch: the middle piece
    of the longest slot's visible KV range, in the split plan of
    attention.plain_split_kv_attention."""
    capacity = inputs["page_indices"].shape[1] * inputs["kv_pages"].shape[1]
    _, split_len = attention.split_kv_plan(capacity, spec["S"], spec["Hkv"])
    s = max(range(len(spec["kv_lens"])), key=lambda i: spec["kv_lens"][i])
    hi = spec["kv_lens"][s]
    lo = max(0, hi - spec["window"]) if spec["window"] else 0
    return s, (lo // split_len + (hi - 1) // split_len) // 2


# ------------------------------------------------------------------ phase 1


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = dict(name=torch.cuda.get_device_name(0), nvidia_smi=smi)
    emit(dict(phase="device", **card, torch=torch.__version__, cuda=torch.version.cuda,
              python=sys.version.split()[0]))
    return card


# ------------------------------------------------------------------ phase 2


def phase_build():
    from scalellm_tpu_torch.ops import _build

    t0 = time.monotonic()
    seconds = _build.build(force=True)
    total = time.monotonic() - t0
    for name in _build.SOURCES:
        log = _build.library_path(name).with_suffix(".log").read_text()
        usage = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        emit(dict(phase="build", kernel=name, seconds=seconds[name], ptxas=usage))
    emit(dict(phase="build", total_seconds=total))


# ------------------------------------------------------------------ phase 3


def page_scales(torch, kv, k_scale, v_scale):
    """[heads, 1] scales of pages [P, page, heads, D]: k_scale at the even
    (K) combined heads, v_scale at the odd (V) ones; a latent cache's one
    head is K."""
    heads = kv.shape[2]
    return torch.tensor([v_scale if h % 2 else k_scale for h in range(heads)], device=kv.device)[:, None]


def quantize_kv_pages(torch, kv, k_scale, v_scale):
    """Float pages as an int8 cache holds them: round(x / scale) clamped to
    [-127, 127]."""
    return torch.round(kv.float() / page_scales(torch, kv, k_scale, v_scale)).clamp(-127, 127).to(torch.int8)


def dequantize_kv_pages(torch, kv, k_scale, v_scale, dtype):
    """int8 pages read back as (int8 -> f32) * scale in `dtype`."""
    return (kv.float() * page_scales(torch, kv, k_scale, v_scale)).to(dtype)


def make_batch(torch, gen, *, q_lens, kv_lens, S, T, H, Hkv, D, page=16, dtype=None):
    """Inputs of ragged paged attention on the card (bf16, or `dtype`).
    Sequence i has a chunk of q_lens[i] tokens at the tail of kv_lens[i];
    slots past len(q_lens) are padding sequences; rows past sum(q_lens) are
    bucket padding; pages are distinct and never page 0."""
    dtype = dtype or torch.bfloat16
    dev = DEVICE
    n_real = len(q_lens)
    maxp_real = max(-(-k // page) for k in kv_lens)
    maxp = next(b for b in (4, 16, 64, 256, 1024) if b >= maxp_real)
    n_pages = 1 + sum(-(-k // page) for k in kv_lens)
    q = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
    kv_pages = torch.randn(n_pages, page, 2 * Hkv, D, generator=gen, device=dev).to(dtype)
    perm = (torch.randperm(n_pages - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros(S, maxp, dtype=torch.int32)
    used = 0
    for i, k in enumerate(kv_lens):
        n = -(-k // page)
        tables[i, :n] = torch.tensor(perm[used : used + n], dtype=torch.int32)
        used += n
    kv = torch.zeros(S, dtype=torch.int32)
    kv[:n_real] = torch.tensor(kv_lens, dtype=torch.int32)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    cu[1 : n_real + 1] = torch.cumsum(torch.tensor(q_lens), 0).to(torch.int32)
    cu[n_real + 1 :] = cu[n_real]
    return dict(
        q=q, kv_pages=kv_pages, kv_lens=kv.to(dev), page_indices=tables.to(dev),
        cu_q_lens=cu.to(dev), num_seqs=torch.tensor([n_real], dtype=torch.int32, device=dev),
    )


def kv_ranges(q_lens, kv_lens, window):
    """Per real token, the KV range [begin, end) it attends to; per
    sequence, the union of its tokens' ranges."""
    tok, seq = [], []
    for ql, kl in zip(q_lens, kv_lens):
        lo_seq = kl
        for i in range(ql):
            pos = kl - ql + i
            begin = max(0, pos - window + 1) if window else 0
            tok.append((begin, pos + 1))
            lo_seq = min(lo_seq, begin)
        seq.append((lo_seq, kl))
    return tok, seq


def bound(spec, inputs):
    """Least time on the card: each input byte read once (the ALiBi slopes
    too; int8 pages a byte an element), each output byte written once, and
    the flops this batch's masks need, at the bf16 tensor-core rate or, in
    f32, the CUDA cores'."""
    H, Hkv, D = spec["H"], spec["Hkv"], spec["D"]
    tok, seq = kv_ranges(spec["q_lens"], spec["kv_lens"], spec["window"])
    size = inputs["q"].element_size()
    kv_bytes = sum(e - b for b, e in seq) * Hkv * 2 * D * inputs["kv_pages"].element_size()
    q_bytes = inputs["q"].numel() * size
    index_bytes = sum(inputs[k].numel() * 4 for k in ("kv_lens", "page_indices", "cu_q_lens", "num_seqs"))
    nbytes = kv_bytes + 2 * q_bytes + index_bytes + (H * 4 if spec.get("alibi") else 0)  # q in, out written
    flops = sum(e - b for b, e in tok) * H * D * 4  # q.k and p.v, multiply-add
    rate = F32_FLOPS_PER_S if size == 4 else BF16_FLOPS_PER_S
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), nbytes, flops


def sdpa_inputs(torch, spec, inputs, alibi_slopes=None):
    """q, K, V gathered per sequence into padded contiguous tensors with
    K/V heads repeated to the q heads, and the boolean mask of causal,
    window and length masking; with ALiBi slopes the mask is additive
    instead, slope * (kv_pos - q_pos) where visible and -inf elsewhere."""
    H, Hkv, D = spec["H"], spec["Hkv"], spec["D"]
    q_lens, kv_lens, window = spec["q_lens"], spec["kv_lens"], spec["window"]
    S, qmax, lmax = len(q_lens), max(q_lens), max(kv_lens)
    page = inputs["kv_pages"].shape[1]
    dtype = inputs["q"].dtype
    qs = torch.zeros(S, H, qmax, inputs["q"].shape[2], dtype=dtype, device=DEVICE)
    ks = torch.zeros(S, Hkv, lmax, D, dtype=dtype, device=DEVICE)
    vs = torch.zeros_like(ks)
    mask = torch.zeros(S, 1, qmax, lmax, dtype=torch.bool, device=DEVICE)
    start = 0
    for i, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        qs[i, :, :ql] = inputs["q"][start : start + ql].transpose(0, 1)
        start += ql
        pages = inputs["page_indices"][i, : -(-kl // page)].long()
        rows = inputs["kv_pages"][pages].reshape(-1, 2 * Hkv, D)[:kl]
        ks[i, :, :kl] = rows[:, 0::2].transpose(0, 1)
        vs[i, :, :kl] = rows[:, 1::2].transpose(0, 1)
        pos = torch.arange(kl - ql, kl, device=DEVICE)[:, None]
        j = torch.arange(lmax, device=DEVICE)[None, :]
        m = (j <= pos) & (j < kl)
        if window:
            m &= j > pos - window
        mask[i, 0, :ql] = m
    rep = H // Hkv
    if alibi_slopes is not None:
        pos = torch.tensor([[kl - ql + t for t in range(qmax)] for ql, kl in zip(q_lens, kv_lens)], device=DEVICE)
        dist = torch.arange(lmax, device=DEVICE)[None, None, :] - pos[:, :, None]  # [S, qmax, lmax]
        bias = alibi_slopes[None, :, None, None] * dist[:, None].float()
        mask = torch.where(mask, bias, float("-inf")).to(dtype)
    return qs, ks.repeat_interleave(rep, 1).contiguous(), vs.repeat_interleave(rep, 1).contiguous(), mask


def time_ms(torch, fn, flush, runs=TIMED_RUNS, dirty_flush=False):
    """Median over `runs` of one call's time on the device, from CUDA events,
    with the L2 cache flushed before each call (the engine reads each
    layer's KV and weights cold). The flush reads a buffer larger than L2,
    so L2 holds clean lines: a flush that writes it (dirty_flush) leaves up
    to 50 MB of dirty lines that the timed call writes back while it reads.
    A spin kernel ahead of the first event
    keeps the device busy while the host enqueues the call, so the events
    bracket the kernels' own time and not the host's time to launch them
    (a wrapper's Python can take longer than its kernel runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if dirty_flush:
            flush.zero_()
        else:
            flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # torch.cuda._sleep is a private API (a spin kernel of that many
        # cycles); checked on torch 2.11.0+cu128.
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


_DECODE_KV = [17, 64, 129, 256, 400, 640, 900, 1024]
# Phase 3a: K1 at the serving paths' shapes. Every 1-token sequence takes
# the split-KV blocks, every longer one the q-tiled blocks.
ATTENTION_SHAPES = {
    # 8 decodes, TinyLlama heads, bucket-padded to T=16, S=8.
    "a_decode": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=32, Hkv=4, D=64, window=None, cap=None),
    # Two prefill chunks (one the tail of a longer context) and six
    # decodes, padded to T=512 as the token ladder pads 456 tokens.
    "b_mixed": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                    S=8, T=512, H=32, Hkv=4, D=64, window=None, cap=None),
    # Head dim 128 with 32:8 GQA (Llama-3-8B heads), decode.
    "c_d128_gqa4": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=32, Hkv=8, D=128, window=None, cap=None),
    # A sliding window plus a logit soft cap on the mixed batch.
    "d_window_softcap": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                             S=8, T=512, H=32, Hkv=4, D=64, window=128, cap=50.0),
    # The mixed batch at Llama-3.1-8B's heads: what a 512-token step of
    # the INT4 run gives the kernel.
    "e_mixed_d128_gqa4": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1],
                              kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                              S=8, T=512, H=32, Hkv=8, D=128, window=None, cap=None),
    # One sequence of 8192 tokens at the 8B heads: 33.5 MB of KV that
    # only split-KV spreads over the card.
    "f_long_d128": dict(q_lens=[1], kv_lens=[8192], S=1, T=16, H=32, Hkv=8, D=128, window=None, cap=None),
    # 64 decodes of 128-2048 tokens, spread evenly, at the 8B heads:
    # about 285 MB of KV, where splitting should nearly stop.
    "g_batch64_d128": dict(q_lens=[1] * 64, kv_lens=[128 + round(i * 1920 / 63) for i in range(64)],
                           S=64, T=64, H=32, Hkv=8, D=128, window=None, cap=None),
    # Qwen1.5-MoE-A2.7B's heads (phase 9): 16 query heads over 16 KV heads,
    # GQA group 1 (MHA), head dim 128; its decode step and its mixed step.
    "h_decode_mha_d128": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=16, Hkv=16, D=128, window=None,
                              cap=None),
    "i_mixed_mha_d128": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                             S=8, T=512, H=16, Hkv=16, D=128, window=None, cap=None),
    # Head dim 256 (phase 10: Gemma-2-9B's heads, 16 over 8, its attention
    # soft cap 50 on every layer; Gemma-2B's 8 over 1): its decode step,
    # its mixed step with the sliding window of its even layers (the only
    # place the window bites: the served contexts stay below 4096), the
    # MQA decode and one 8192-token decode.
    "j_decode_d256_gqa2": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=16, Hkv=8, D=256, window=None,
                               cap=50.0),
    "k_mixed_d256_window_softcap": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1],
                                        kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                                        S=8, T=512, H=16, Hkv=8, D=256, window=128, cap=50.0),
    "l_decode_mqa_d256": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=8, Hkv=1, D=256, window=None,
                              cap=None),
    "m_long_d256": dict(q_lens=[1], kv_lens=[8192], S=1, T=16, H=16, Hkv=8, D=256, window=None, cap=None),
    # ALiBi at MPT-7B's heads (phase 13: 32 over 32, head dim 128), its
    # decode step and its mixed step; the slopes of layers/alibi.py.
    "n_decode_alibi_mpt7b": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=32, Hkv=32, D=128, window=None,
                                 cap=None, alibi=True),
    "o_mixed_alibi_mpt7b": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                                S=8, T=512, H=32, Hkv=32, D=128, window=None, cap=None, alibi=True),
    # Head dim 80 at Phi-2's heads (phase 12: 32 over 32).
    "p_decode_d80_phi2": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=32, Hkv=32, D=80, window=None,
                              cap=None),
    "q_mixed_d80_phi2": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                             S=8, T=512, H=32, Hkv=32, D=80, window=None, cap=None),
    # float32 at GPT-2's heads (phase 15: 12 over 12, head dim 64): K1's f32
    # kernel, held within F32_TOL.
    "r_decode_f32_gpt2": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=12, Hkv=12, D=64, window=None,
                              cap=None, dtype="float32"),
    "s_mixed_f32_gpt2": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                             S=8, T=512, H=12, Hkv=12, D=64, window=None, cap=None, dtype="float32"),
    # int8 pages (phases 16-18, kv_cache_dtype="int8") at KV_INT8_SCALES:
    # Llama-3.1-8B's heads (32 over 8, head dim 128), its decode step and
    # its mixed step; MPT-7B's with ALiBi; GPT-2's in float32 (K1's f32
    # kernel over int8 pages).
    "t_decode_int8_llama8b": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=32, Hkv=8, D=128, window=None,
                                  cap=None, kv_int8=True),
    "u_mixed_int8_llama8b": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1],
                                 kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024], S=8, T=512, H=32, Hkv=8, D=128,
                                 window=None, cap=None, kv_int8=True),
    "v_decode_int8_alibi_mpt7b": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=32, Hkv=32, D=128,
                                      window=None, cap=None, alibi=True, kv_int8=True),
    "w_decode_int8_f32_gpt2": dict(q_lens=[1] * 8, kv_lens=_DECODE_KV, S=8, T=16, H=12, Hkv=12, D=64, window=None,
                                   cap=None, dtype="float32", kv_int8=True),
    # Phase 19's verify batch: 8 sequences of k + 1 = 5 queries over 16-600
    # tokens of context at Llama-2-7B's heads (32 over 32, head dim 128),
    # T = S (k + 1) = 40 rows, as a speculative round gives the kernel.
    "x_verify_llama2_7b": dict(q_lens=[5] * 8, kv_lens=[16, 64, 129, 200, 300, 411, 512, 600], S=8, T=40, H=32,
                               Hkv=32, D=128, window=None, cap=None),
}


def phase_kernels(torch, card):
    import torch.nn.functional as F

    from scalellm_tpu_torch.layers.alibi import alibi_slopes
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention as plain

    kernel = attention.ragged_paged_attention_cuda
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    results = {}
    for name, spec in ATTENTION_SHAPES.items():
        f32 = spec.get("dtype") == "float32"
        inputs = make_batch(torch, gen, q_lens=spec["q_lens"], kv_lens=spec["kv_lens"], S=spec["S"],
                            T=spec["T"], H=spec["H"], Hkv=spec["Hkv"], D=spec["D"],
                            dtype=torch.float32 if f32 else torch.bfloat16)
        kw = dict(sm_scale=spec["D"] ** -0.5, sliding_window=spec["window"], logit_soft_cap=spec["cap"])
        if spec.get("alibi"):
            kw["alibi_slopes"] = torch.tensor(alibi_slopes(spec["H"]), dtype=torch.float32, device=DEVICE)
        int8 = spec.get("kv_int8", False)
        if int8:
            inputs["kv_pages"] = quantize_kv_pages(torch, inputs["kv_pages"], *KV_INT8_SCALES)
            kw.update(k_scale=KV_INT8_SCALES[0], v_scale=KV_INT8_SCALES[1])
        got = kernel(**inputs, **kw)
        torch.cuda.synchronize()
        want = plain(**inputs, **kw)
        n_real = sum(spec["q_lens"])
        tol = F32_TOL if f32 else KERNEL_TOL
        if not torch.isfinite(got).all():
            fail(f"{name}: kernel output is not finite")
        if not torch.all(got[n_real:] == 0):
            fail(f"{name}: padding rows are not zero")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= tol:
            fail(f"{name}: kernel differs from the plain version by {err} > {tol}")
        rel_err = attention_row_rel_err(torch, got, want)
        if not rel_err <= ATTENTION_REL_TOL:
            fail(f"{name}: kernel differs from the plain version by {rel_err} of a row > {ATTENTION_REL_TOL}")
        planted = {}
        if all(n == 1 for n in spec["q_lens"]) and not f32:  # the f32 kernel has no split-KV merge
            # The check must see a merge that lost a piece: the plain
            # split-and-merge with the longest slot's middle piece left out.
            drop = dropped_piece(attention, spec, inputs)
            lost = attention.plain_split_kv_attention(**inputs, **kw, drop=drop)
            planted = dict(planted_drop=drop, planted_rel_err=attention_row_rel_err(torch, lost, want),
                           planted_abs_err=(lost.float() - want.float()).abs().max().item())
            if not planted["planted_rel_err"] > ATTENTION_REL_TOL:
                fail(f"{name}: the check passes a merge that lost piece {drop}: {planted}")
            del lost
        ms = time_ms(torch, lambda: kernel(**inputs, **kw), flush)
        plain_ms = time_ms(torch, lambda: plain(**inputs, **kw), flush)
        library_ms = None
        if spec["cap"] is None:  # SDPA has no soft cap: no library call computes (d), (j), (k)
            # int8 pages: SDPA over pages dequantized ahead of time (no
            # PyTorch call reads int8 pages).
            lib_inputs = inputs if not int8 else dict(inputs, kv_pages=dequantize_kv_pages(
                torch, inputs["kv_pages"], *KV_INT8_SCALES, inputs["q"].dtype))
            qs, ks, vs, mask = sdpa_inputs(torch, spec, lib_inputs, kw.get("alibi_slopes"))
            del lib_inputs
            library_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=kw["sm_scale"]),
                flush)
        bound_ms, bound_by, nbytes, flops = bound(spec, inputs)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        page = inputs["kv_pages"].shape[1]
        splits, split_len = attention.split_kv_plan(inputs["page_indices"].shape[1] * page, spec["S"],
                                                    spec["Hkv"], attention._sm_count(inputs["q"].device))
        emit(dict(phase="kernel", kernel="ragged_paged_attention" + ("_f32" if f32 else "") + ("_int8" if int8 else ""),
                  shape=name, tol=tol, kv_scales=KV_INT8_SCALES if int8 else None,
                  rel_tol=ATTENTION_REL_TOL, max_row_rel_err=rel_err, **planted, T=spec["T"], S=spec["S"],
                  real_tokens=n_real, H=spec["H"], Hkv=spec["Hkv"], D=spec["D"], window=spec["window"],
                  soft_cap=spec["cap"], alibi=bool(spec.get("alibi")), dtype=str(inputs["q"].dtype),
                  splits=None if f32 else splits, split_len=None if f32 else split_len, bytes=nbytes, flops=flops,
                  **results[name], card=card["nvidia_smi"]))
        del inputs, got, want
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 3b

# The Llama-3.1-8B projections: (K, N, bits, RMSNorm before it).
QUANT_SHAPES = {
    # TinyLlama-1.1B's fused qkv projection: one k-block spans K = 2048, so a
    # 128-token step runs the RMSNorm in the tile kernel's prologue. At the
    # 8B widths plan() never fuses it above M = 64 (K = 4096 is two k-blocks).
    "qkv_proj_k2048": (2048, 2560, 4, True),
    "qkv_proj": (4096, 6144, 4, True),
    "o_proj": (4096, 4096, 4, False),
    "gate_up_proj": (4096, 28672, 4, True),
    "down_proj": (14336, 4096, 4, False),
    "lm_head": (4096, 128256, 8, False),
}


def quant_operands(torch, gen, K, N, bits, asym, group=GROUP, bf16_scales=False):
    """Random kernel-layout weights on the card: every nibble (byte) value,
    f32 scales for the int4 projections (as a GPTQ checkpoint's f16 scales
    load) and bf16 scales for the int8 lm_head or with bf16_scales (as the
    load-time quantizer makes them), sized so that the dequantized weights
    have std ~0.02."""
    rows = K // 2 if bits == 4 else K
    qweight = torch.randint(-128, 128, (N, rows), generator=gen, device=DEVICE, dtype=torch.int8)
    unit = 0.02 / (4.6 if bits == 4 else 74.0)
    scales = (torch.rand(K // group, N, generator=gen, device=DEVICE) + 0.5) * unit
    if bits == 8 or bf16_scales:
        scales = scales.to(torch.bfloat16)
    zeros = None
    if asym:
        zeros = torch.randint(-8, 8, (K // group, N), generator=gen, device=DEVICE, dtype=torch.int8)
    return qweight, scales, zeros


def deepseek_shared_down():
    """(K, N, G) of DeepSeek-V2-Lite's shared experts' down projection as
    phase 7's model quantizes it: K = the shared experts' width, N = the
    hidden size, G from the model's own rule."""
    from scalellm_tpu_torch.models.deepseek import pick_group

    K = DEEPSEEK_V2_LITE["moe_intermediate_size"] * DEEPSEEK_V2_LITE["n_shared_experts"]
    return K, DEEPSEEK_V2_LITE["hidden_size"], pick_group(K, 4)


def l2_bytes(M, K, N, bits, rows, tokens):
    """Bytes a tile kernel moves through L2: every column tile reads all of
    x, every token tile all of the packed weights."""
    w_bytes = N * K // 2 if bits == 4 else N * K
    return M * K * 2 * -(-N // rows) + w_bytes * -(-M // tokens)


def dequantized(torch, qweight, scales, zeros, bits):
    """bf16 [N, K] weights dequantized ahead of time: the operand of the
    library yardsticks."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    K = qweight.shape[1] * (2 if bits == 4 else 1)
    group_of_k = torch.arange(K, device=DEVICE) // (K // scales.shape[0])
    wd = Q.unpack_signed(qweight, bits).to(torch.bfloat16)
    if zeros is not None:
        wd -= zeros.to(torch.bfloat16).T[:, group_of_k]
    wd *= scales.to(torch.bfloat16).T[:, group_of_k]
    return wd


def check_quant(torch, name, got, want):
    """The quantized matmuls' tolerance (QUANT_TOL_*); returns (max error,
    mean error, output magnitude)."""
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    diff = (got.float() - want.float()).abs()
    top = want.float().abs().max().item()
    err, mean_err = diff.max().item(), diff.mean().item()
    if not (err <= QUANT_TOL_MAX * top and mean_err <= QUANT_TOL_MEAN * top):
        fail(f"{name}: differs from the plain version by {err} (mean {mean_err}) at output magnitude {top}")
    return err, mean_err, top


def phase_quant_kernels(torch, card):
    from scalellm_tpu_torch.ops import quant_matmul as Q

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    wrappers = dict(w4a8=Q.quant_matmul_w4a8_cuda, group=Q.quant_matmul_group_cuda,
                    dequant=Q.quant_matmul_dequant_cuda)
    plains = dict(w4a8=Q.plain_w4a8, group=Q.plain_group, dequant=Q.plain_dequant)
    # (kernel, M, asymmetric) per shape; one asymmetric case per kernel.
    cases = [("w4a8", m, False) for m in (1, 8, 16, 64)] + [("dequant", 512, False), ("group", 512, False)]
    extra = {"o_proj": [("w4a8", 16, True), ("dequant", 512, True), ("group", 512, True)],
             "gate_up_proj": [("dequant", 128, False), ("dequant", 256, False)]}
    only = {"qkv_proj_k2048": [("dequant", 128, False), ("group", 128, False)],
            "deepseek_shared_down": [("dequant", 16, False)]}
    ds_K, ds_N, ds_G = deepseek_shared_down()
    shapes = dict(QUANT_SHAPES, deepseek_shared_down=(ds_K, ds_N, 4, False))
    groups = dict(deepseek_shared_down=ds_G)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {name: {} for name in wrappers}
    for shape, (K, N, bits, has_norm) in shapes.items():
        tile_n = Q.LM_HEAD_TILE_N if shape == "lm_head" else Q.DEFAULT_TILE_N
        G = groups.get(shape, GROUP)
        for kernel_name, M, asym in only.get(shape, cases + extra.get(shape, [])):
            qweight, scales, zeros = quant_operands(torch, gen, K, N, bits, asym, group=G,
                                                    bf16_scales=shape in groups)
            x = (torch.randn(M, K, generator=gen, device=DEVICE) + 0.25).to(torch.bfloat16)
            gamma = None
            if has_norm:
                gamma = (torch.rand(K, generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
            # As the dispatcher would call the kernel on the model's path:
            # its block_k, and the norm in the prologue only where it fuses.
            variant, block_k, fuse = Q.plan(M, K, N, bits, G, scales.dtype.itemsize, has_norm,
                                            variant=kernel_name, tile_n=tile_n)
            if variant != kernel_name:
                fail(f"{shape} M={M}: plan() turned {kernel_name} into {variant}")
            if shape == "qkv_proj_k2048" and not fuse:
                fail(f"{shape} M={M}: plan() does not put the norm in {kernel_name}'s prologue")
            if gamma is not None and not fuse:
                x, gamma = Q.rms_prologue(x, gamma, 1e-5), None
            args = (x, qweight, scales, zeros, bits) + ((block_k,) if kernel_name == "w4a8" else ())
            kernel = lambda: wrappers[kernel_name](*args, gamma, 1e-5)
            plain = lambda: plains[kernel_name](*args, gamma, 1e-5)
            got = kernel()
            torch.cuda.synchronize()
            err, mean_err, top = check_quant(torch, f"{kernel_name} {shape} M={M} asym={asym}", got,
                                             plain().to(torch.bfloat16))
            ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush, runs=3)
            # Yardstick: one bf16 matmul on weights dequantized ahead of time
            # (and x normalised ahead of time where the prologue runs).
            wd = dequantized(torch, qweight, scales, zeros, bits)
            xn = x if gamma is None else Q.rms_prologue(x, gamma, 1e-5)
            library_ms = time_ms(torch, lambda: torch.matmul(xn, wd.T), flush)
            del wd
            nbytes = sum(t.numel() * t.element_size() for t in (x, qweight, scales, zeros, gamma)
                         if t is not None) + M * N * 2
            ops = 2 * M * K * N
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = ops / (INT8_OPS_PER_S if kernel_name == "w4a8" else BF16_FLOPS_PER_S)
            r = dict(max_abs_err=err, mean_abs_err=mean_err, out_magnitude=top, ms=ms,
                     plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                     bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms)
            results[kernel_name][(shape, M, asym)] = r
            tile = None
            if kernel_name != "w4a8":
                tile = Q.TILES[Q.tile_shape(kernel_name, M, K, N, G, sms)]
            emit(dict(phase="kernel", kernel="quant_matmul_" + kernel_name, shape=shape, M=M, K=K,
                      N=N, bits=bits, group=G, asymmetric=asym, block_k=block_k,
                      rms_prologue=gamma is not None, tile=tile, tol_max=QUANT_TOL_MAX * top, bytes=nbytes,
                      ops=ops, **r, card=card["nvidia_smi"]))
            if kernel_name != "w4a8" and M == 512 and not asym:
                emit(dict(phase="kernel_probe", kernel="quant_matmul_" + kernel_name, shape=shape, M=M,
                          what="bytes through L2 of the chosen tiles (64 x 64 tiles' beside)",
                          tile=tile, l2_bytes=l2_bytes(M, K, N, bits, *tile),
                          l2_bytes_64x64=l2_bytes(M, K, N, bits, 64, 64)))
            del qweight, scales, zeros, x, got
        torch.cuda.empty_cache()
    # What bounds a w4a8 call now. Its pre-pass (act_quant_kernel: the
    # RMSNorm where it fuses, the int8 quantization, each span's sums and
    # scale) against the main grid, which starts as its programmatic
    # dependent and streams its first weight stages meanwhile: device time a
    # call of each, under torch.profiler, at the decode step's shapes (M =
    # 16; L2 flushed before each call). And the floor of a call: one block's
    # worth of rows (N = 32, four K slices of 8 rows a half), so the time is
    # the pre-pass, one ring fill and one block walking K.
    for shape, (K, N, bits, has_norm) in QUANT_SHAPES.items():
        tile_n = Q.LM_HEAD_TILE_N if shape == "lm_head" else Q.DEFAULT_TILE_N
        qweight, scales, _ = quant_operands(torch, gen, K, N, bits, False)
        x = (torch.randn(16, K, generator=gen, device=DEVICE) + 0.25).to(torch.bfloat16)
        gamma = (torch.rand(K, generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16) if has_norm else None
        _, block_k, fuse = Q.plan(16, K, N, bits, GROUP, scales.element_size(), has_norm, tile_n=tile_n)
        if gamma is not None and not fuse:
            x, gamma = Q.rms_prologue(x, gamma, 1e-5), None
        split = kernel_split(torch, lambda: wrappers["w4a8"](x, qweight, scales, None, bits, block_k, gamma, 1e-5),
                             flush, dict(pre_pass_ms=("act_quant_kernel",), main_ms=("w4a8_kernel",)))
        emit(dict(phase="kernel_probe", kernel="quant_matmul_w4a8", shape=shape, M=16, K=K, N=N,
                  rms_prologue=gamma is not None,
                  what="device ms a call: the pre-pass, and the main grid that overlaps it", **split,
                  card=card["nvidia_smi"]))
        del qweight, scales, x
    for K in (4096, 14336):
        qweight, scales, _ = quant_operands(torch, gen, K, 32, 4, False)
        x = torch.randn(16, K, generator=gen, device=DEVICE).to(torch.bfloat16)
        ms = time_ms(torch, lambda: wrappers["w4a8"](x, qweight, scales, None, 4, 2048, None, 1e-5), flush)
        emit(dict(phase="kernel_probe", kernel="quant_matmul_w4a8", what="one block: M=16, N=32",
                  K=K, ms=ms, card=card["nvidia_smi"]))
    return results


# ------------------------------------------------------------------ phase 3c

# deepseek-ai/DeepSeek-V2-Lite config.json (bench.py preset
# "deepseek-v2-lite" carries the same widths), in bf16.
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2", architectures=["DeepseekV2ForCausalLM"], torch_dtype="bfloat16",
    hidden_size=2048, intermediate_size=10944, num_hidden_layers=27, num_attention_heads=16,
    num_key_value_heads=16, vocab_size=102400, max_position_embeddings=163840,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="silu", tie_word_embeddings=False,
    bos_token_id=100000, eos_token_id=100001, q_lora_rank=None, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128, first_k_dense_replace=1,
    moe_layer_freq=1, n_routed_experts=64, num_experts_per_tok=6, moe_intermediate_size=1408,
    n_shared_experts=2, norm_topk_prob=False, routed_scaling_factor=1.0, topk_method="greedy",
    n_group=1, topk_group=1,
    rope_scaling=dict(type="yarn", factor=40, original_max_position_embeddings=4096,
                      beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707),
)
# mistralai/Mixtral-8x7B-v0.1 config.json, in bf16 (phase 8 cuts its depth).
MIXTRAL_8X7B = dict(
    model_type="mixtral", architectures=["MixtralForCausalLM"], torch_dtype="bfloat16",
    hidden_size=4096, intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, vocab_size=32000, max_position_embeddings=32768, rms_norm_eps=1e-5,
    rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
    sliding_window=None, num_local_experts=8, num_experts_per_tok=2, router_aux_loss_coef=0.02,
)
# Phases 5-7's depths: cut (from 32 and 27) to keep the whole script within
# about half its time limit once phases 8 and 9 serve their larger models.
INT4_LAYERS = 16
DEEPSEEK_LAYERS = 14
# Phase 8's depth: 8 of Mixtral-8x7B's 32 layers (1.451 B parameters, 2.90
# GB, a layer; 23.7 GB in bf16 with the embedding and lm_head). 16 layers
# (47.0 GB; the runtime INT4 quantization of that on the card peaks near 59
# GB) ran until phase 20 came in and the whole script read 937.7 s of its
# 1200.
MIXTRAL_LAYERS = 8
# Phases 10 and 11's depths: cut (from 42 and 36) once phases 12-15 came in,
# so that a slow host keeps the whole script below 900 s (the script's time
# swings by up to 1.4x between calls: 643 and 907 s for the same tree).
GEMMA2_LAYERS = 16
QWEN3_LAYERS = 14
# Phases 12 and 13's depths: cut (from 32 each) once phase 22 came in and the
# whole script read 926.5 s of its 1200 (phase 13 51.2 s, phase 12 43.3 s).
PHI2_LAYERS = 16
MPT_LAYERS = 8
# Qwen/Qwen1.5-MoE-A2.7B's widths (the reference loader's qwen2_moe
# defaults), in bf16.
QWEN15_MOE_A27B = dict(
    model_type="qwen2_moe", architectures=["Qwen2MoeForCausalLM"], torch_dtype="bfloat16",
    hidden_size=2048, intermediate_size=5632, num_hidden_layers=24, num_attention_heads=16,
    num_key_value_heads=16, vocab_size=151936, max_position_embeddings=8192, rms_norm_eps=1e-6,
    rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False, bos_token_id=151643,
    eos_token_id=151643, num_experts=60, num_experts_per_tok=4, moe_intermediate_size=1408,
    shared_expert_intermediate_size=5632, norm_topk_prob=False, decoder_sparse_step=1, mlp_only_layers=[],
)
# google/gemma-2-9b config.json (its torch_dtype float32 served as bf16;
# benchmarks/presets.py's gemma2-9b-int8 carries query_pre_attn_scalar 224
# and vocab 256128 where the published config has 256 and 256000).
GEMMA2_9B = dict(
    model_type="gemma2", architectures=["Gemma2ForCausalLM"], torch_dtype="bfloat16",
    hidden_size=3584, intermediate_size=14336, num_hidden_layers=42, num_attention_heads=16,
    num_key_value_heads=8, head_dim=256, vocab_size=256000, max_position_embeddings=8192, rms_norm_eps=1e-6,
    rope_theta=10000.0, hidden_act="gelu_pytorch_tanh", hidden_activation="gelu_pytorch_tanh",
    query_pre_attn_scalar=256, sliding_window=4096, attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
    tie_word_embeddings=True, bos_token_id=2, eos_token_id=1,
)
# Qwen/Qwen3-8B config.json.
QWEN3_8B = dict(
    model_type="qwen3", architectures=["Qwen3ForCausalLM"], torch_dtype="bfloat16",
    hidden_size=4096, intermediate_size=12288, num_hidden_layers=36, num_attention_heads=32,
    num_key_value_heads=8, head_dim=128, vocab_size=151936, max_position_embeddings=40960, rms_norm_eps=1e-6,
    rope_theta=1e6, hidden_act="silu", tie_word_embeddings=False, attention_bias=False,
    use_sliding_window=False, bos_token_id=151643, eos_token_id=151645,
)
# microsoft/phi-2 config.json (the port's loader defaults are Phi-1.5's; its
# torch_dtype float16 is served as bf16, the reference's dtype rule).
PHI2 = dict(
    model_type="phi", architectures=["PhiForCausalLM"], torch_dtype="float16",
    hidden_size=2560, intermediate_size=10240, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=32, partial_rotary_factor=0.4, vocab_size=51200, hidden_act="gelu_new",
    layer_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=2048, tie_word_embeddings=False,
    bos_token_id=50256, eos_token_id=50256,
)
# mosaicml/mpt-7b config.json (ALiBi, no biases, clip_qkv and softmax_scale
# null).
MPT_7B = dict(
    model_type="mpt", architectures=["MPTForCausalLM"], torch_dtype="bfloat16",
    d_model=4096, n_heads=32, n_layers=32, expansion_ratio=4, max_seq_len=2048, vocab_size=50432,
    no_bias=True, attn_config=dict(alibi=True, alibi_bias_max=8, clip_qkv=None, softmax_scale=None),
)
# bigscience/bloom-560m config.json (served as bf16).
BLOOM_560M = dict(
    model_type="bloom", architectures=["BloomForCausalLM"], torch_dtype="bfloat16",
    hidden_size=1024, n_head=16, n_layer=24, vocab_size=250880, layer_norm_epsilon=1e-5,
    bos_token_id=1, eos_token_id=2,
)
# openai-community/gpt2 config.json (the loader's defaults; float32, as
# the reference serves it).
GPT2 = dict(
    model_type="gpt2", architectures=["GPT2LMHeadModel"], torch_dtype="float32",
    n_embd=768, n_layer=12, n_head=12, n_positions=1024, vocab_size=50257, activation_function="gelu_new",
    layer_norm_epsilon=1e-5, bos_token_id=50256, eos_token_id=50256,
)
# Where a config.json keeps its depth (the rest: num_hidden_layers).
LAYERS_KEY = {"mpt": "n_layers", "bloom": "n_layer", "gpt2": "n_layer"}


def layers_of(cfg) -> int:
    return cfg[LAYERS_KEY.get(cfg["model_type"], "num_hidden_layers")]


def with_layers(cfg, n):
    """`cfg` cut to depth n."""
    return dict(cfg, **{LAYERS_KEY.get(cfg["model_type"], "num_hidden_layers"): n})


# The routed experts of each MoE model the phases serve: (hidden, expert
# width, experts, top-k).
MOE_WIDTHS = {
    "v2_lite": (DEEPSEEK_V2_LITE["hidden_size"], DEEPSEEK_V2_LITE["moe_intermediate_size"],
                DEEPSEEK_V2_LITE["n_routed_experts"], DEEPSEEK_V2_LITE["num_experts_per_tok"]),
    "mixtral": (MIXTRAL_8X7B["hidden_size"], MIXTRAL_8X7B["intermediate_size"],
                MIXTRAL_8X7B["num_local_experts"], MIXTRAL_8X7B["num_experts_per_tok"]),
    "qwen2_moe": (QWEN15_MOE_A27B["hidden_size"], QWEN15_MOE_A27B["moe_intermediate_size"],
                  QWEN15_MOE_A27B["num_experts"], QWEN15_MOE_A27B["num_experts_per_tok"]),
}
# The grouped GEMM against its plain version: both sum exact bf16 products
# in f32, in another order: 1e-4 of the output's largest magnitude.
GMM_TOL = 1e-4


def routed_rows(torch, gen, T, E, k, K, n_pad=0):
    """xs of T tokens routed to k of E experts by a seeded softmax (so some
    experts get no rows), sorted by expert, and the group sizes. The last
    n_pad tokens are the engine's padding rows: they share one input, so
    all of them route to the same k experts."""
    def rows(shape):
        x = torch.randn(*shape, generator=gen, device=DEVICE)
        if n_pad:
            x[T - n_pad:] = x[T - n_pad]
        return x

    probs = torch.softmax(rows((T, E)), dim=-1)
    experts = torch.topk(probs, k, dim=-1).indices.reshape(-1)
    order = torch.sort(experts, stable=True).indices
    x = rows((T, K)).to(torch.bfloat16)
    sizes = torch.bincount(experts, minlength=E).to(torch.int32)
    return x[order // k].contiguous(), sizes


def library_grouped_mm(torch, xs, w, sizes):
    """One PyTorch call computing the grouped GEMM, where this build has it
    (torch._grouped_mm, bf16 on sm_90, bf16 out): (name, fn). Else a loop
    of torch.matmul over the experts that have rows."""
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    wt = w.transpose(1, 2)  # [E, K, N], K-major per expert
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(xs, wt, offs=offs)
            torch.cuda.synchronize()
            return "torch._grouped_mm", lambda: torch._grouped_mm(xs, wt, offs=offs)
        except (RuntimeError, TypeError) as e:
            print(f"torch._grouped_mm refused: {e}", file=sys.stderr, flush=True)
    bounds = [0] + torch.cumsum(sizes, 0).tolist()
    active = [e for e in range(w.shape[0]) if bounds[e + 1] > bounds[e]]

    def loop():
        return [torch.matmul(xs[bounds[e]:bounds[e + 1]], w[e].T) for e in active]

    return "torch.matmul loop over active experts", loop


def latent_batch(torch, gen, *, q_lens, kv_lens, S, T, H, Dc, page=16):
    """Inputs of MLA paged attention on the card: make_batch's layout with
    one K-only latent head [P, page, 1, Dc]."""
    b = make_batch(torch, gen, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, H=H, Hkv=1, D=Dc, page=page)
    b["k_pages"] = b.pop("kv_pages")[:, :, :1].contiguous()
    return b


def mla_library_inputs(torch, spec, inputs, v_dim):
    """q, K, V gathered per sequence for scaled_dot_product_attention (the
    one latent head broadcast to the query heads) and the boolean mask."""
    q_lens, kv_lens = spec["q_lens"], spec["kv_lens"]
    H, Dc = spec["H"], spec["Dc"]
    S, qmax, lmax = len(q_lens), max(q_lens), max(kv_lens)
    page = inputs["k_pages"].shape[1]
    qs = torch.zeros(S, H, qmax, Dc, dtype=torch.bfloat16, device=DEVICE)
    ks = torch.zeros(S, 1, lmax, Dc, dtype=torch.bfloat16, device=DEVICE)
    mask = torch.zeros(S, 1, qmax, lmax, dtype=torch.bool, device=DEVICE)
    start = 0
    for i, (ql, kl) in enumerate(zip(q_lens, kv_lens)):
        qs[i, :, :ql] = inputs["q"][start : start + ql].transpose(0, 1)
        start += ql
        pages = inputs["page_indices"][i, : -(-kl // page)].long()
        ks[i, 0, :kl] = inputs["k_pages"][pages].reshape(-1, Dc)[:kl]
        pos = torch.arange(kl - ql, kl, device=DEVICE)[:, None]
        j = torch.arange(lmax, device=DEVICE)[None, :]
        mask[i, 0, :ql] = (j <= pos) & (j < kl)
    ks = ks.expand(S, H, lmax, Dc)
    return qs, ks, ks[..., :v_dim], mask


# Phase 3c: K9 and K10 at DeepSeek-V2-Lite's heads (16) over the 576-wide
# latent cache. K9 takes the decode-only batches, K10 the mixed one.
MLA_SHAPES = {
    # 8 decodes, padded to T=16, S=8: the engine's decode step.
    "decode": dict(q_lens=[1] * 8, kv_lens=[16, 40, 90, 150, 233, 310, 480, 600], S=8, T=16),
    # Two prefill chunks and six decodes padded to T=512.
    "mixed": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                  S=8, T=512),
    # One sequence of 8192 tokens: 9.4 MB of latent rows that only
    # split-KV spreads over the card.
    "decode_8192": dict(q_lens=[1], kv_lens=[8192], S=1, T=16),
    # 64 decodes of 128-2048 tokens, spread evenly: about 80 MB.
    "decode_64": dict(q_lens=[1] * 64, kv_lens=[128 + round(i * 1920 / 63) for i in range(64)], S=64, T=64),
    # int8 latent pages (phase 17, kv_cache_dtype="int8") at
    # LATENT_INT8_SCALE: the decode step and the mixed step.
    "decode_int8": dict(q_lens=[1] * 8, kv_lens=[16, 40, 90, 150, 233, 310, 480, 600], S=8, T=16, int8=True),
    "mixed_int8": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                       S=8, T=512, int8=True),
}


def gmm_cases(torch, gen):
    """Phase 3c's K6 inputs at each MOE_WIDTHS model's widths, as the engine
    runs them: a decode step of 8 tokens padded to T=16 (the 8 padding rows
    share one input), 16 k rows (V2-Lite 96, Mixtral 32, Qwen2-MoE 64); a
    512-token step, 512 k rows; each for gate/up (D -> Fm) and down (Fm ->
    D). Yields (model, step, proj, xs, w, group sizes)."""
    for model, (D, Fm, E, k) in MOE_WIDTHS.items():
        for step, T, n_pad in (("decode", 16, 8), ("prefill", 512, 0)):
            for proj, K, N in (("gate_up", D, Fm), ("down", Fm, D)):
                xs, sizes = routed_rows(torch, gen, T, E, k, K, n_pad)
                w = (torch.randn(E, N, K, generator=gen, device=DEVICE) * K ** -0.5).to(torch.bfloat16)
                yield model, step, proj, xs, w, sizes
                del xs, w


def moe_shape(model, name):
    """A phase-3 shape name: V2-Lite's as before, the others prefixed."""
    return name if model == "v2_lite" else f"{model}_{name}"


def phase_moe_mla_kernels(torch, card):
    import torch.nn.functional as F

    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops import grouped_matmul as G
    from scalellm_tpu_torch.ops import mla_attention as M

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 2)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    cfg = DEEPSEEK_V2_LITE
    gmm = {}
    for model, step, proj, xs, w, sizes in gmm_cases(torch, gen):
        E, N, K = w.shape
        shape = moe_shape(model, f"{step}_{proj}")
        got = G.grouped_matmul_cuda(xs, w, sizes)
        torch.cuda.synchronize()
        want = G.plain_grouped_matmul(xs, w, sizes)
        if not torch.isfinite(got).all():
            fail(f"grouped_matmul {shape}: kernel output is not finite")
        top = want.abs().max().item()
        err = (got - want).abs().max().item()
        if not err <= GMM_TOL * top:
            fail(f"grouped_matmul {shape}: differs from the plain version by {err} at magnitude {top}")
        lib_name, lib = library_grouped_mm(torch, xs, w, sizes)
        lib_out = lib()  # one tensor, or the active experts' rows in order
        lib_out = lib_out if isinstance(lib_out, torch.Tensor) else torch.cat(lib_out)
        lib_err = (lib_out.float() - want).abs().max().item()
        del lib_out
        ms = time_ms(torch, lambda: G.grouped_matmul_cuda(xs, w, sizes), flush)
        # The block shapes' A/B: every (weight rows, tokens) of G.TILES
        # on the same inputs, each against the wrapper's choice.
        by_tile, diff_by_tile = {}, {}
        for t, (rows, toks) in enumerate(G.TILES):
            name = f"{rows}x{toks}"
            by_tile[name] = time_ms(torch, lambda t=t: G.grouped_matmul_cuda(xs, w, sizes, tile=t), flush)
            diff_by_tile[name] = (G.grouped_matmul_cuda(xs, w, sizes, tile=t) - got).abs().max().item()
        default = G.TILES[G.tile_for(xs.shape[0], E)]
        emit(dict(phase="kernel_probe", kernel="grouped_matmul", shape=shape,
                  what="block shape (weight rows x tokens) A/B", ms_by_tile=by_tile,
                  max_abs_diff_vs_default=diff_by_tile, default_tile=f"{default[0]}x{default[1]}",
                  card=card["nvidia_smi"]))
        plain_ms = time_ms(torch, lambda: G.plain_grouped_matmul(xs, w, sizes), flush, runs=3)
        library_ms = time_ms(torch, lib, flush)
        active = int((sizes > 0).sum())
        nbytes = xs.numel() * 2 + active * N * K * 2 + sizes.numel() * 4 + xs.shape[0] * N * 4
        ops = 2 * xs.shape[0] * K * N
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
        r = dict(max_abs_err=err, out_magnitude=top, ms=ms, plain_ms=plain_ms,
                 bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms)
        gmm[(model, step, proj)] = r
        emit(dict(phase="kernel", kernel="grouped_matmul", shape=shape, R=xs.shape[0], K=K,
                  N=N, E=E, active_experts=active, tol=GMM_TOL * top, bytes=nbytes, ops=ops,
                  library=lib_name, library_max_abs_err=lib_err, **r, card=card["nvidia_smi"]))
        del xs, w, got, want
        torch.cuda.empty_cache()

    H, Dc, vd = cfg["num_attention_heads"], cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"], cfg["kv_lora_rank"]
    # The model's softmax scale: (qk head dim)^-0.5 times yarn's mscale^2.
    from scalellm_tpu_torch.models.deepseek import yarn_get_mscale

    yarn = cfg["rope_scaling"]
    sm_scale = ((cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
                * yarn_get_mscale(yarn["factor"], yarn["mscale_all_dim"]) ** 2)
    mla = {"mla_decode": {}, "mla_prefill": {}, "mla_decode_int8": {}, "mla_prefill_int8": {}}
    for name, spec in MLA_SHAPES.items():
        spec = dict(spec, H=H, Dc=Dc)
        inputs = latent_batch(torch, gen, q_lens=spec["q_lens"], kv_lens=spec["kv_lens"], S=spec["S"],
                              T=spec["T"], H=H, Dc=Dc)
        int8 = spec.get("int8", False)
        scale = {}
        if int8:
            inputs["k_pages"] = quantize_kv_pages(torch, inputs["k_pages"], LATENT_INT8_SCALE, None)
            scale = dict(k_scale=LATENT_INT8_SCALE)
        decode_only = all(n == 1 for n in spec["q_lens"])
        kernel_name = ("mla_decode" if decode_only else "mla_prefill") + ("_int8" if int8 else "")
        dec_args = (inputs["q"], inputs["k_pages"], inputs["kv_lens"], inputs["page_indices"])
        if decode_only:
            kernel = lambda: M.mla_decode_attention_cuda(*dec_args, sm_scale=sm_scale, v_dim=vd, **scale)
        else:
            kernel = lambda: M.mla_prefill_attention_cuda(**inputs, sm_scale=sm_scale, v_dim=vd, **scale)
        plain = lambda: M.plain_mla_paged_attention(**inputs, sm_scale=sm_scale, v_dim=vd,
                                                    decode_only=decode_only, **scale)
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        n_real = sum(spec["q_lens"])
        if not torch.isfinite(got).all():
            fail(f"{kernel_name} {name}: kernel output is not finite")
        if not torch.all(got[n_real:] == 0):
            fail(f"{kernel_name} {name}: padding rows are not zero")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"{kernel_name} {name}: differs from the plain version by {err} > {KERNEL_TOL}")
        rel_err = attention_row_rel_err(torch, got, want)
        if not rel_err <= ATTENTION_REL_TOL:
            fail(f"{kernel_name} {name}: differs from the plain version by {rel_err} of a row > {ATTENTION_REL_TOL}")
        capacity = inputs["page_indices"].shape[1] * inputs["k_pages"].shape[1]
        splits, split_len = M.mla_split_plan(capacity, spec["S"], -(-H // M.HEAD_GROUP),
                                             attention._sm_count(inputs["q"].device))
        planted = {}
        if decode_only:
            # The check must see a merge that lost a piece: the plain
            # split-and-merge with the longest slot's middle piece left out.
            s_long = max(range(len(spec["kv_lens"])), key=lambda i: spec["kv_lens"][i])
            drop = (s_long, (spec["kv_lens"][s_long] - 1) // split_len // 2)
            lost = M.plain_mla_split_decode(*dec_args, sm_scale=sm_scale, v_dim=vd, drop=drop, **scale)
            planted = dict(planted_drop=drop, planted_rel_err=attention_row_rel_err(torch, lost, want),
                           planted_abs_err=(lost.float() - want.float()).abs().max().item())
            if not planted["planted_rel_err"] > ATTENTION_REL_TOL:
                fail(f"{kernel_name} {name}: the check passes a merge that lost piece {drop}: {planted}")
            del lost
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush, runs=5)
        # int8 pages: SDPA over pages dequantized ahead of time.
        lib_inputs = inputs if not int8 else dict(inputs, k_pages=dequantize_kv_pages(
            torch, inputs["k_pages"], LATENT_INT8_SCALE, None, torch.bfloat16))
        qs, ks, vs, mask = mla_library_inputs(torch, spec, lib_inputs, vd)
        del lib_inputs
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                                             scale=sm_scale), flush)
        del qs, ks, vs, mask
        # The attention grid's and the merge's device time a call.
        split = kernel_split(torch, kernel, flush, dict(attention_ms=["mla_attention_kernel"],
                                                        merge_ms=["mla_merge_kernel"]))
        emit(dict(phase="kernel_probe", kernel=kernel_name, shape=name, what="device ms a call by grid",
                  **split, card=card["nvidia_smi"]))
        tok, seq = kv_ranges(spec["q_lens"], spec["kv_lens"], None)
        nbytes = (sum(e - b for b, e in seq) * Dc * inputs["k_pages"].element_size() + n_real * H * (Dc + vd) * 2
                  + sum(inputs[x].numel() * 4 for x in ("kv_lens", "page_indices", "cu_q_lens", "num_seqs")))
        flops = sum(e - b for b, e in tok) * H * (Dc + vd) * 2
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms)
        mla[kernel_name][name] = r
        emit(dict(phase="kernel", kernel=kernel_name, shape=name, T=spec["T"], S=spec["S"],
                  real_tokens=n_real, H=H, Dc=Dc, v_dim=vd, splits=splits, split_len=split_len,
                  tile_tokens=None if decode_only else M.TILE_TOKENS, tol=KERNEL_TOL,
                  rel_tol=ATTENTION_REL_TOL, max_row_rel_err=rel_err, **planted, bytes=nbytes, flops=flops,
                  library="scaled_dot_product_attention", **r, card=card["nvidia_smi"]))
        del inputs, got, want
        torch.cuda.empty_cache()
    return gmm, mla


def pytorch_expert_dequant(torch, qweight, scales, K):
    """The PyTorch form that the expert dequantization kernel replaced in
    ops/moe_quant.py: the sign-extended nibbles of each half, then one int8
    x bf16 broadcast product a half, rounded once, with each row's even K
    first and its odd K after."""
    E, N, _ = qweight.shape
    n_g = scales.shape[1]
    s = scales.transpose(1, 2)[..., None]
    w = torch.empty(E, N, 2, K // 2, dtype=torch.bfloat16, device=qweight.device)
    for half, nibbles in enumerate(((qweight << 4) >> 4, qweight >> 4)):
        torch.mul(nibbles.view(E, N, n_g, -1), s, out=w[:, :, half].view(E, N, n_g, -1))
    return w.view(E, N, K)


def phase_expert_dequant(torch, card):
    """The INT4 expert dequantization at DeepSeek-V2-Lite's routed experts
    (64 of them, group 128): gate/up (2048 -> 1408) and down (1408 -> 2048),
    and at Mixtral-8x7B's (8 of 4096 -> 14336 and 14336 -> 4096: what every
    INT4 Mixtral step runs before K6), bit for bit against the plain
    version, timed beside the PyTorch form it replaced and its bound (packed
    weights and scales read once, bf16 weights written once, over 3.35
    TB/s)."""
    from scalellm_tpu_torch.ops import moe_quant as MQ

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 4)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    results = {}
    cases = []
    for model in ("v2_lite", "mixtral"):
        D, Fm, E, _ = MOE_WIDTHS[model]
        cases += [(moe_shape(model, "gate_up"), E, D, Fm), (moe_shape(model, "down"), E, Fm, D)]
    for proj, E, K, N in cases:
        qweight = torch.randint(-128, 128, (E, N, K // 2), generator=gen, device=DEVICE, dtype=torch.int8)
        scales = ((torch.rand(E, K // GROUP, N, generator=gen, device=DEVICE) + 0.5) * 0.01).to(torch.bfloat16)
        got = MQ.expert_dequant_cuda(qweight, scales, K)
        torch.cuda.synchronize()
        want = MQ.plain_dequantize_experts_bf16(qweight, scales, K)
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            fail(f"expert_dequant {proj}: the kernel's bf16 weights are not the plain version's bits")
        old = pytorch_expert_dequant(torch, qweight, scales, K)
        same_values = torch.equal(old, torch.cat([got[..., 0::2], got[..., 1::2]], dim=-1))
        del old, want
        ms = time_ms(torch, lambda: MQ.expert_dequant_cuda(qweight, scales, K), flush)
        plain_ms = time_ms(torch, lambda: MQ.plain_dequantize_experts_bf16(qweight, scales, K), flush, runs=3)
        form_ms = time_ms(torch, lambda: pytorch_expert_dequant(torch, qweight, scales, K), flush)
        nbytes = qweight.numel() + scales.numel() * 2 + got.numel() * 2
        r = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                 bound_by="bytes", library_ms=None)
        results[proj] = r
        emit(dict(phase="kernel", kernel="expert_dequant", shape=proj, E=E, K=K, N=N, G=GROUP, bytes=nbytes,
                  bit_identical=True, replaced_pytorch_form_ms=form_ms,
                  replaced_form_same_values_even_k_first=same_values, **r, card=card["nvidia_smi"]))
        if not same_values:
            fail(f"expert_dequant {proj}: the replaced PyTorch form gives other values")
        del qweight, scales, got
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------------ phase 3d

# K7/K8 against their plain versions: both multiply the same exact products
# (bf16 x int4/int8, exact in f32) and sum in f32 in another order before the
# group or channel scale: 1e-4 of the output's largest magnitude.
MOE_QUANT_TOL = 1e-4


def moe_probe(torch, nbytes, row_bytes):
    """The stream probe's operands for `nbytes` of weights (whole rows of
    row_bytes, int8, one scale group, weights only): a call that reads the
    same bytes as a routed-expert call reads of weights and scales."""
    from scalellm_tpu_torch.ops import quant_matmul as Q

    rows = -(-nbytes // row_bytes)
    x = torch.zeros(1, row_bytes, dtype=torch.bfloat16, device=DEVICE)
    q = torch.zeros(rows, row_bytes, dtype=torch.int8, device=DEVICE)
    s = torch.ones(1, rows, device=DEVICE)
    return rows * row_bytes, lambda: Q.quant_stream_probe_cuda(x, q, s, None, 8, row_bytes, weights_only=True)


def moe_quant_cases(torch, gen):
    """Phase 3d's cases, one dict each: K8 (gate and up, 2048 -> 1408) and
    K7 (down, 1408 -> 2048, 11 groups of 128) at DeepSeek-V2-Lite's decode
    step (96 rows routed as in phase 3c) and in the T=1 layout (one token
    over 8 rows, 6 experts, starts given), int4 at G = 128 and int8; then
    at Qwen1.5-MoE-A2.7B's INT4 decode step (60 experts, top-4: 64 rows;
    layout "qwen2_moe_decode"). `args` are the wrapper's (xs, qweight,
    scales[, qweight, scales], sizes, active, starts); `order` sorts the
    rows in groups by expert."""
    from scalellm_tpu_torch.layers.moe import single_token_layout
    from scalellm_tpu_torch.ops import moe_quant as MQ

    def experts(E, K, N, bits):
        w = torch.randn(E, N, K, generator=gen, device=DEVICE) * K ** -0.5
        return MQ.quantize_experts_int4(w, GROUP) if bits == 4 else MQ.quantize_experts_int8(w)

    def rows(n, K):
        return torch.randn(n, K, generator=gen, device=DEVICE).to(torch.bfloat16)

    for model, bits, layouts in (("v2_lite", 4, ("decode", "t1")), ("v2_lite", 8, ("decode", "t1")),
                                 ("qwen2_moe", 4, ("qwen2_moe_decode",))):
        D, Fm, E, k = MOE_WIDTHS[model]
        gate, up, down = experts(E, D, Fm, bits), experts(E, D, Fm, bits), experts(E, Fm, D, bits)
        for layout in layouts:
            if layout != "t1":
                xs, sizes = routed_rows(torch, gen, 16, E, k, D, n_pad=8)
                h = rows(xs.shape[0], Fm)
                active, starts = MQ.active_experts(sizes, min(E, xs.shape[0])), MQ.expert_starts(sizes)
                order = torch.arange(xs.shape[0], device=DEVICE)  # already sorted by expert
            else:
                topk_e = torch.randperm(E, generator=gen, device=DEVICE)[:k].reshape(1, k)
                Tp, sizes, starts, active, _ = single_token_layout(topk_e, torch.ones(1, k, device=DEVICE), E)
                xs, h = rows(1, D).expand(Tp, -1).contiguous(), rows(Tp, Fm)
                order = torch.argsort(topk_e[0])
            for proj, x, weights, K, N in (("gate_up", xs, (gate, up), D, Fm), ("down", h, (down,), Fm, D)):
                yield dict(name=f"{proj}_int{bits}_{layout}", proj=proj, bits=bits, layout=layout, K=K, N=N, E=E,
                           x=x, weights=weights, sizes=sizes, active=active, starts=starts, order=order,
                           n_active=int((active >= 0).sum()), covered=int(sizes.sum()),
                           args=(x, *[t for pair in weights for t in pair], sizes, active, starts))
        del gate, up, down
        torch.cuda.empty_cache()


def check_moe_quant(torch, name, got, want, covered):
    """Outputs finite, within MOE_QUANT_TOL of the plain version's largest
    magnitude, and 0 on the rows outside every group: (error, magnitude)."""
    if not all(torch.isfinite(g).all() for g in got):
        fail(f"moe_quant {name}: kernel output is not finite")
    top = max(w.abs().max().item() for w in want)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    if not err <= MOE_QUANT_TOL * top:
        fail(f"moe_quant {name}: differs from the plain version by {err} at magnitude {top}")
    if not all(torch.all(g[covered:] == 0) for g in got):
        fail(f"moe_quant {name}: rows outside every group are not zero")
    return err, top


def phase_moe_quant_kernels(torch, card):
    """Every moe_quant_cases case against its plain version, timed beside
    the library yardstick, with the rate at which it reads the active
    experts' weights and scales and the stream probe's on the same bytes."""
    from scalellm_tpu_torch.ops import moe_quant as MQ

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 3)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    results = {}
    for c in moe_quant_cases(torch, gen):
        args, weights, K, N, sizes = c["args"], c["weights"], c["K"], c["N"], c["sizes"]
        if c["proj"] == "gate_up":
            kernel = lambda: MQ.grouped_quant_matmul_pair_cuda(*args)
            plain = lambda: MQ.plain_grouped_quant_matmul_pair(*args)
        else:
            kernel = lambda: (MQ.grouped_quant_matmul_cuda(*args),)
            plain = lambda: (MQ.plain_grouped_quant_matmul(*args),)
        got = kernel()
        torch.cuda.synchronize()
        err, top = check_moe_quant(torch, c["name"], got, plain(), c["covered"])
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush, runs=3)
        # Yardstick: torch._grouped_mm (or the matmul loop) over the same
        # rows in expert order, on bf16 weights dequantized ahead of time.
        x, covered, n_active = c["x"], c["covered"], c["n_active"]
        x_sorted = x[:covered][c["order"][:covered]].contiguous()
        libs = [library_grouped_mm(torch, x_sorted, MQ.dequantize_experts(q, sc, K).to(torch.bfloat16), sizes)
                for q, sc in weights]
        lib_name = libs[0][0]
        library_ms = time_ms(torch, lambda: [fn() for _, fn in libs], flush)
        del libs
        w_bytes = sum(q[0].numel() * q.element_size() + sc[0].numel() * sc.element_size() for q, sc in weights)
        nbytes = (x.numel() * 2 + n_active * w_bytes + len(weights) * x.shape[0] * N * 4
                  + (c["active"].numel() + c["starts"].numel() + sizes.numel()) * 4)
        ops = 2 * covered * K * N * len(weights)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
        probe_bytes, probe = moe_probe(torch, n_active * w_bytes, weights[0][0].shape[-1])
        probe_ms = time_ms(torch, probe, flush)
        rate, probe_rate = n_active * w_bytes / (ms * 1e-3), probe_bytes / (probe_ms * 1e-3)
        r = dict(max_abs_err=err, out_magnitude=top, ms=ms, plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
                 weight_gb_per_s=rate / 1e9, probe_ms=probe_ms, probe_gb_per_s=probe_rate / 1e9,
                 of_probe=rate / probe_rate)
        del probe
        results[(c["proj"], c["bits"], c["layout"])] = r
        emit(dict(phase="kernel", kernel="moe_quant_decode_pair" if c["proj"] == "gate_up" else "moe_quant_decode",
                  shape=c["name"], R=x.shape[0], K=K, N=N, E=c["E"], bits=c["bits"],
                  group=GROUP if c["bits"] == 4 else None, active_experts=n_active, rows_in_groups=covered,
                  tol=MOE_QUANT_TOL * top, bytes=nbytes, ops=ops,
                  library=lib_name + " on pre-dequantized bf16 weights", **r, card=card["nvidia_smi"]))
    return results


# ------------------------------------------------------------------ phase 3e

# The phase-3b shapes the small-M variants and the probe are timed at:
# (shape, asymmetric).
SMALL_M_SHAPES = (("qkv_proj", False), ("o_proj", False), ("o_proj", True),
                  ("gate_up_proj", False), ("down_proj", False), ("lm_head", False))
SMALL_M_ROWS = (1, 16, 64)
# K11 at Llama-3.1-8B's MLP, int4 at G = 128 with bf16 scales (what runtime
# quantization stores): 91 MB of weights and scales.
MLP_D, MLP_F = LLAMA31_8B_INT4["hidden_size"], LLAMA31_8B_INT4["intermediate_size"]
MLP_ROWS = (1, 8, 16, 32, 64)  # up to the edge of its contract, M <= 64
# K11 against its plain version: g and u are f32 sums of exact products in
# another order, where they fall on a bf16 boundary an element of h moves by
# one bf16 step, and down sums exact products of h in another order: 1e-3
# of the output's largest magnitude, mean error 2e-5 of it.
MLP_TOL_MAX, MLP_TOL_MEAN = 1e-3, 2e-5


def phase_small_m_kernels(torch, card):
    """K12a (gemv) and K12b (w4a8g) at the 8B projection shapes, M = 1, 16
    and 64, against their plain versions, beside K2 and K3 (as the
    dispatcher runs them) and one bf16 matmul on weights dequantized ahead
    of time; K12c (the stream probe) at the same shapes, exactly against its
    plain version, with the rate at which it reads the weights; K11 at the
    8B MLP, symmetric and asymmetric, M = 1, 8, 16, 32 and 64, beside the
    two-launch path (K2 gate_up, silu * up, K2 down: timed only, its
    numerics differ) and two bf16 matmuls with the activation. Then K11's
    own path: its entry point quant_mlp at those M (no model calls it)."""
    import torch.nn.functional as TF

    from scalellm_tpu_torch.ops import quant_matmul as Q
    from scalellm_tpu_torch.ops import quant_mlp as QM

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 4)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    results = dict(gemv={}, w4a8g={}, stream={}, mlp={})
    wrappers = dict(gemv=(Q.quant_gemv_cuda, Q.plain_gemv), w4a8g=(Q.quant_w4a8_gemv_cuda, Q.plain_w4a8g))
    for shape, asym in SMALL_M_SHAPES:
        K, N, bits, has_norm = QUANT_SHAPES[shape]
        tile_n = Q.LM_HEAD_TILE_N if shape == "lm_head" else Q.DEFAULT_TILE_N
        name = shape + ("_asym" if asym else "")
        qweight, scales, zeros = quant_operands(torch, gen, K, N, bits, asym)
        wd = dequantized(torch, qweight, scales, zeros, bits)
        w_bytes = sum(t.numel() * t.element_size() for t in (qweight, scales, zeros) if t is not None)
        for M in SMALL_M_ROWS:
            x = (torch.randn(M, K, generator=gen, device=DEVICE) + 0.25).to(torch.bfloat16)
            gamma = None
            if has_norm:
                gamma = (torch.rand(K, generator=gen, device=DEVICE) + 0.5).to(torch.bfloat16)
            xn = x if gamma is None else Q.rms_prologue(x, gamma, 1e-5)
            yard = {v: time_ms(torch, lambda v=v: Q.quant_matmul(
                x, qweight, scales, zeros, bits=bits, variant=v, rms_gamma=gamma, rms_eps=1e-5,
                tile_n=tile_n), flush) for v in ("w4a8", "group")}
            library_ms = time_ms(torch, lambda: torch.matmul(xn, wd.T), flush)
            for variant, (wrapper, plain_fn) in wrappers.items():
                v, block_k, fuse = Q.plan(M, K, N, bits, GROUP, scales.element_size(), has_norm,
                                          variant=variant, tile_n=tile_n)
                if v != variant:
                    fail(f"{name} M={M}: plan() turned {variant} into {v}")
                xv, g = (x, gamma) if fuse else (xn, None)
                extra = (block_k,) if variant == "w4a8g" else ()
                kernel = lambda: wrapper(xv, qweight, scales, zeros, bits, *extra, g, 1e-5)
                plain = lambda: plain_fn(xv, qweight, scales, zeros, bits, *extra, g, 1e-5)
                got = kernel()
                torch.cuda.synchronize()
                err, mean_err, top = check_quant(torch, f"{variant} {name} M={M}", got, plain().to(torch.bfloat16))
                ms = time_ms(torch, kernel, flush)
                plain_ms = time_ms(torch, plain, flush, runs=3)
                nbytes = (x.numel() * 2 + w_bytes + M * N * 2
                          + (g.numel() * g.element_size() if g is not None else 0))
                ops = 2 * M * K * N
                t_bytes = nbytes / HBM_BYTES_PER_S
                t_ops = ops / (INT8_OPS_PER_S if variant == "w4a8g" else BF16_FLOPS_PER_S)
                r = dict(max_abs_err=err, mean_abs_err=mean_err, out_magnitude=top, ms=ms,
                         plain_ms=plain_ms, bound_ms=1e3 * max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=library_ms,
                         w4a8_ms=yard["w4a8"], group_ms=yard["group"],
                         weight_gb_per_s=w_bytes / (ms * 1e-3) / 1e9)
                results[variant][(name, M)] = r
                emit(dict(phase="kernel", kernel="quant_" + variant, shape=name, M=M, K=K, N=N,
                          bits=bits, group=GROUP, asymmetric=asym, block_k=block_k,
                          rms_prologue=g is not None, tol_max=QUANT_TOL_MAX * top, bytes=nbytes,
                          ops=ops, **r, card=card["nvidia_smi"]))
                del got
            # The probe: every weight, scale and zero byte, as the default
            # variant's k-blocks; the norm, where the call has one, ahead.
            _, block_k, _ = Q.plan(M, K, N, bits, GROUP, scales.element_size(), has_norm,
                                   variant="stream", tile_n=tile_n)
            probe = lambda: Q.quant_stream_probe_cuda(xn, qweight, scales, zeros, bits, block_k)
            plain = lambda: Q.plain_stream(xn, qweight, scales, zeros, bits, block_k)
            got = probe()
            torch.cuda.synchronize()
            err = (got.float() - plain().to(torch.bfloat16).float()).abs().max().item()
            if err != 0:
                fail(f"stream probe {name} M={M}: differs from the plain version by {err}")
            ms = time_ms(torch, probe, flush)
            plain_ms = time_ms(torch, plain, flush, runs=3)
            weights_only_ms = time_ms(torch, lambda: Q.quant_stream_probe_cuda(
                xn, qweight, scales, zeros, bits, block_k, weights_only=True), flush)
            if (name, M) == ("gate_up_proj", 16):
                # The flush A/B, in turns: zeroing (dirty lines), reading, reading, zeroing.
                ab = [time_ms(torch, probe, flush, dirty_flush=d) for d in (True, False, False, True)]
                emit(dict(phase="kernel_probe", kernel="quant_stream_probe", shape=name, M=M,
                          what="L2 flush A/B: zeroing, reading, reading, zeroing a 128 MB buffer",
                          ms=ab, weight_gb_per_s=[w_bytes / (t * 1e-3) / 1e9 for t in ab],
                          card=card["nvidia_smi"]))
            rate = w_bytes / (ms * 1e-3)
            if rate > HBM_BYTES_PER_S:
                fail(f"stream probe {name} M={M}: reads {rate / 1e12:.3f} TB/s, more than the memory gives")
            nbytes = w_bytes + M * N * 2 + (K // block_k) * 2
            r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                     bound_by="bytes", library_ms=None, weight_gb_per_s=rate / 1e9,
                     weights_only_ms=weights_only_ms,
                     weights_only_gb_per_s=qweight.numel() * qweight.element_size() / (weights_only_ms * 1e-3) / 1e9)
            results["stream"][(name, M)] = r
            emit(dict(phase="kernel", kernel="quant_stream_probe", shape=name, M=M, K=K, N=N, bits=bits,
                      asymmetric=asym, block_k=block_k, bytes=nbytes, **r, card=card["nvidia_smi"]))
            del x, xn, got
        del qweight, scales, zeros, wd
        torch.cuda.empty_cache()

    # K11 at the 8B MLP.
    D, Fi = MLP_D, MLP_F
    mlp_inputs = {}
    for asym in (False, True):
        gq, gs, gz = quant_operands(torch, gen, D, 2 * Fi, 4, asym)
        dq, ds, dz = quant_operands(torch, gen, Fi, D, 4, asym)
        gate_up, down = (gq, gs.to(torch.bfloat16), gz), (dq, ds.to(torch.bfloat16), dz)
        wd_gu, wd_dn = dequantized(torch, *gate_up, 4), dequantized(torch, *down, 4)
        w_bytes = sum(t.numel() * t.element_size() for t in gate_up + down if t is not None)

        def two_launch():
            gu = Q.quant_matmul(x, *gate_up, bits=4, variant="w4a8")
            g, u = gu.chunk(2, dim=-1)
            h = (TF.silu(g.float()) * u.float()).to(torch.bfloat16)
            return Q.quant_matmul(h, *down, bits=4, variant="w4a8")

        def library():
            g, u = torch.matmul(x, wd_gu.T).chunk(2, dim=-1)
            return torch.matmul((TF.silu(g.float()) * u.float()).to(torch.bfloat16), wd_dn.T)

        for M in MLP_ROWS:
            x = (torch.randn(M, D, generator=gen, device=DEVICE) + 0.25).to(torch.bfloat16)
            kernel = lambda: QM.quant_mlp_cuda(x, gate_up, down, Fi, 4, "silu")
            plain = lambda: QM.plain_quant_mlp(x, gate_up, down, Fi, 4, "silu")
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            name = f"llama8b_mlp{'_asym' if asym else ''}"
            if not torch.isfinite(got).all():
                fail(f"quant_mlp {name} M={M}: kernel output is not finite")
            diff = (got - want).abs()
            top = want.abs().max().item()
            err, mean_err = diff.max().item(), diff.mean().item()
            if not (err <= MLP_TOL_MAX * top and mean_err <= MLP_TOL_MEAN * top):
                fail(f"quant_mlp {name} M={M}: differs from the plain version by {err} (mean {mean_err}) "
                     f"at output magnitude {top}")
            ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush, runs=3)
            two_launch_ms = time_ms(torch, two_launch, flush)
            library_ms = time_ms(torch, library, flush)
            nbytes = x.numel() * 2 + w_bytes + M * D * 4
            ops = 2 * M * 3 * D * Fi
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
            r = dict(max_abs_err=err, mean_abs_err=mean_err, out_magnitude=top, ms=ms, plain_ms=plain_ms,
                     bound_ms=1e3 * max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                     library_ms=library_ms, two_launch_ms=two_launch_ms,
                     weight_gb_per_s=w_bytes / (ms * 1e-3) / 1e9)
            results["mlp"][(name, M)] = r
            emit(dict(phase="kernel", kernel="quant_mlp", shape=name, M=M, D=D, F=Fi, bits=4, group=GROUP,
                      asymmetric=asym, tol_max=MLP_TOL_MAX * top, bytes=nbytes, ops=ops,
                      library="two bf16 torch.matmul + silu on pre-dequantized weights",
                      two_launch="K2 gate_up, silu * up, K2 down", **r, card=card["nvidia_smi"]))
            del got, want, diff
        mlp_inputs[asym] = (gate_up, down)
        del wd_gu, wd_dn
        torch.cuda.empty_cache()

    # K11's own path: the entry point a user calls, at the decode sizes.
    QM.quant_mlp_cuda.launches = 0
    for M in MLP_ROWS:
        x = torch.randn(M, D, generator=gen, device=DEVICE).to(torch.bfloat16)
        out = QM.quant_mlp(x, *mlp_inputs[False], Fi, bits=4, act="silu", symmetric=True)
        if out.shape != (M, D) or not torch.isfinite(out).all():
            fail(f"quant_mlp at M={M}: output {tuple(out.shape)} is not finite [M, D]")
    torch.cuda.synchronize()
    mlp_launches = QM.quant_mlp_cuda.launches
    emit(dict(phase="quant_mlp_path", rows=list(MLP_ROWS), launches=mlp_launches))
    del mlp_inputs
    torch.cuda.empty_cache()
    return results, mlp_launches


# ------------------------------------------------------------------ phase 4


def char_tokenizer_json():
    """The char-level WordLevel tokenizer.json of tests/fixtures.py
    (token id == ord(char) for ids < 256)."""
    return {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": [],
        "normalizer": None,
        "pre_tokenizer": {"type": "Split", "pattern": {"String": ""}, "behavior": "Isolated", "invert": False},
        "post_processor": None, "decoder": {"type": "Fuse"},
        "model": {"type": "WordLevel", "vocab": {chr(i): i for i in range(256)}, "unk_token": "\x00"},
    }


def checkpoint_tensors(cfg):
    """(HF name, shape, is norm) of every tensor of a Llama checkpoint."""
    D, F_, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    Dh = D // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [
            (p + "self_attn.q_proj.weight", (Hq, D), False),
            (p + "self_attn.k_proj.weight", (Hkv, D), False),
            (p + "self_attn.v_proj.weight", (Hkv, D), False),
            (p + "self_attn.o_proj.weight", (D, Hq), False),
            (p + "mlp.gate_proj.weight", (F_, D), False),
            (p + "mlp.up_proj.weight", (F_, D), False),
            (p + "mlp.down_proj.weight", (D, F_), False),
            (p + "input_layernorm.weight", (D,), True),
            (p + "post_attention_layernorm.weight", (D,), True),
        ]
    out += [("model.norm.weight", (D,), True), ("lm_head.weight", (V, D), False)]
    return out


def flat_init(cfg):
    """Phases 4-9's random weights: every weight N(0, 0.02), every norm of
    weight 1 (stored as 0 where the model's norms are zero-centred)."""
    norm = 0.0 if cfg["model_type"].startswith("gemma") else 1.0
    return lambda name, shape, is_norm: norm if is_norm else 0.02


# Names of a checkpoint's embedding tables, and of the last projection of a
# residual branch (attention's output, the MLP's down), over the families
# the phases serve.
EMBEDDINGS = ("embed_tokens", "wte", "wpe", "word_embeddings")
BRANCH_ENDS = ("o_proj", "down_proj", "attn.c_proj", "mlp.c_proj", "self_attn.dense.", "mlp.fc2", "attn.out_proj",
               "self_attention.dense.", "dense_4h_to_h")


def scaled_init(cfg):
    """Phases 10-15's random weights, drawn by fan-in as variance scaling
    does (PaLM): a weight N(0, 1 / sqrt(in)) (GPT-2's Conv1D weights are
    [in, out], the others [out, in]); an untied embedding N(0, 1), a tied
    one and GPT-2's learned positions N(0, 1 / sqrt(hidden)) (the tied
    table's fan-in as the lm_head; Gemma scales it by sqrt(hidden) on
    input); and each residual branch's last op scaled by 1 / sqrt(2 *
    layers) (GPT-2): its output projection, or the post-block norms where
    the model has them. Norms have weight 1 otherwise, stored as 0 where
    they are zero-centred (Gemma); biases (listed as constants beside the
    norms) are 0. With phases 4-9's N(0, 0.02), the layers of 24- to
    42-layer models swamp their embeddings, and rounding alone moves their
    logits past LOGITS_TOL between any two implementations (PERF.md §6;
    tools/logits_drift.py)."""
    import scalellm_tpu_torch.models  # noqa: F401  (registers the loaders)
    from scalellm_tpu_torch.models.registry import ModelRegistry

    a = ModelRegistry.get_model_args_loader(cfg["model_type"])(dict(cfg))
    branch = (2 * a.n_layers) ** -0.5
    post_norms = ("post_attention_layernorm", "post_feedforward_layernorm") if cfg["model_type"] == "gemma2" else ()
    conv1d = cfg["model_type"] == "gpt2"

    def init(name, shape, is_norm):
        if is_norm:
            if name.endswith(".bias"):
                return 0.0
            w = branch if any(n in name for n in post_norms) else 1.0
            return w - 1.0 if a.zero_centered_norm else w
        if any(e in name for e in EMBEDDINGS):
            return a.hidden_size ** -0.5 if a.tie_word_embeddings or "wpe" in name else 1.0
        std = (shape[0] if conv1d else shape[-1]) ** -0.5
        return std * branch if not post_norms and any(b in name for b in BRANCH_ENDS) else std

    return init


def checkpoint_dtype(torch, cfg):
    """(torch dtype, safetensors name) of a checkpoint written for `cfg`:
    float32 where its torch_dtype says so (GPT-2), else bf16."""
    return (torch.float32, "F32") if cfg.get("torch_dtype") == "float32" else (torch.bfloat16, "BF16")


def write_checkpoint(torch, path, cfg, tensors=None, init=None):
    """config.json, tokenizer.json and model.safetensors (bf16, or f32 for a
    float32 cfg; from a seeded generator) of the (HF name, shape, is a
    constant) list `tensors`, by default a Llama checkpoint's: a constant
    (a norm's weight, a bias) filled with init(name, shape, True), any other
    tensor N(0, init(name, shape, False)); `init` by default
    flat_init(cfg)."""
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(char_tokenizer_json(), f)
    tensors = tensors or checkpoint_tensors(cfg)
    init = init or flat_init(cfg)
    dtype, st_dtype = checkpoint_dtype(torch, cfg)
    header, offset = {}, 0
    for name, shape, _ in tensors:
        n = dtype.itemsize
        for d in shape:
            n *= d
        header[name] = {"dtype": st_dtype, "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, shape, is_norm in tensors:
            value = init(name, shape, is_norm)
            if is_norm:
                t = torch.full(shape, value, dtype=dtype)
            else:
                t = (torch.randn(shape, generator=gen, device=DEVICE) * value).to(dtype).cpu()
            f.write(memoryview(t.view(torch.uint8).numpy().reshape(-1)))
    return offset


def prompts(seed=SEED):
    """8 prompts of 16-600 chars; the first two share a 450-char prefix."""
    import random

    rng = random.Random(seed)
    words = ["attention", "kernel", "paged", "cache", "token", "batch", "decode", "prefill",
             "the", "a", "of", "and", "to", "in", "model", "serving", "layer", "query"]

    def text(n):
        s = ""
        while len(s) < n:
            s += rng.choice(words) + " "
        return s[:n]

    shared = text(450)
    out = [shared + text(150), shared + text(100)]
    out += [text(n) for n in (16, 40, 100, 200, 333, 600)]
    return out


def batch_inputs(torch, seqs, page=16, lora=None):
    """ModelInputs of one batch, padded to the bucket ladders. seqs holds one
    (token ids, first position, context length to reserve pages for) per
    sequence; each sequence owns its own pages, handed out in order from
    page 1 (page 0 is reserved), so a later batch with the same reservations
    finds the same pages. lora: each sequence's LoRA adapter slot (None:
    no lora_ids). Returns (inputs, pages used)."""
    from scalellm_tpu_torch.engine.batch import PAGE_BUCKETS, SEQ_BUCKETS, TOKEN_BUCKETS, pick_bucket
    from scalellm_tpu_torch.engine.params import ModelInputs

    n = [len(ids) for ids, _, _ in seqs]
    T, S = pick_bucket(TOKEN_BUCKETS, sum(n)), pick_bucket(SEQ_BUCKETS, len(n))
    maxp = pick_bucket(PAGE_BUCKETS, max(-(-total // page) for _, _, total in seqs))
    tok = torch.zeros(T, dtype=torch.int32)
    pos = torch.zeros(T, dtype=torch.int32)
    seg = torch.zeros(T, dtype=torch.int32)
    slots = torch.zeros(T, dtype=torch.int32)
    tables = torch.zeros(S, maxp, dtype=torch.int32)
    kv = torch.zeros(S, dtype=torch.int32)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    sel = torch.zeros(S, dtype=torch.int32)
    t, next_page = 0, 1
    for s, (ids, start, total) in enumerate(seqs):
        k = len(ids)
        pages = torch.arange(next_page, next_page + -(-total // page), dtype=torch.int32)
        next_page += len(pages)
        p = torch.arange(start, start + k, dtype=torch.int32)
        tok[t : t + k] = torch.tensor(ids, dtype=torch.int32)
        pos[t : t + k] = p
        seg[t : t + k] = s
        slots[t : t + k] = pages[p // page] * page + p % page
        tables[s, : len(pages)] = pages
        kv[s] = start + k
        cu[s + 1] = t + k
        sel[s] = t + k - 1
        t += k
    cu[len(n) + 1 :] = cu[len(n)]
    lora_ids = None
    if lora is not None:
        lora_ids = torch.zeros(S, dtype=torch.int32)
        lora_ids[: len(lora)] = torch.tensor(lora, dtype=torch.int32)
    mi = ModelInputs(token_ids=tok, positions=pos, token_seg=seg, new_kv_slot_ids=slots,
                     block_tables=tables, kv_lens=kv, cu_q_lens=cu,
                     num_seqs=torch.tensor([len(n)], dtype=torch.int32), selected_idxes=sel,
                     seq_mask=(torch.arange(S) < len(n)).float(), lora_ids=lora_ids)
    return mi, next_page


def union_ms(spans):
    """The time (ms) covered by (start_us, end_us, ...) intervals."""
    total, end = 0.0, None
    for start, stop, *_ in sorted(spans):
        if end is None or start > end:
            total, end = total + stop - start, stop
        elif stop > end:
            total, end = total + stop - end, stop
    return total / 1e3


def device_breakdown(prof, wall_s, steps):
    """Device time by kernel from a profiler trace, in seven groups (the
    attention kernels, the quantized matmul kernels with their activation
    quantization, the grouped GEMM, the routed quantized-expert kernels, the
    int4 expert dequantization, library matrix products, the rest), the
    shares of the quantized group of the K3/K4 tile kernel (with its
    pre-pass) and of K2 (w4a8_ms: w4a8_kernel with its pre-pass
    act_quant_kernel, which K12b shares), the kernels launched per engine
    step, and the share of `wall_s` the device was idle. Kernels run on one
    stream, but a grid launched as a programmatic dependent (K2's main grid,
    K1's and K9/K10's merges, gemv) starts while the one before it runs: the groups sum
    each kernel's own time, while the busy time and w4a8_ms are the union
    of the kernels' device intervals, so an overlap counts once."""
    from torch.autograd import DeviceType

    per_name = {}
    spans = []
    # The profiler's raw events: prof.events() first builds a tree of
    # FunctionEvents over every CPU op, which takes tens of seconds for a
    # serve of a 36- or 42-layer model (100k kernels and as many ops).
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            ms, n = per_name.get(name, (0.0, 0))
            per_name[name] = (ms + e.duration_ns() / 1e6, n + 1)
            spans.append((e.start_ns() / 1e3, e.end_ns() / 1e3, name))
    groups = dict(attention_ms=0.0, quant_matmul_ms=0.0, grouped_matmul_ms=0.0, moe_quant_ms=0.0,
                  expert_dequant_ms=0.0, matmul_ms=0.0, other_ms=0.0)
    for name, (ms, _) in per_name.items():
        low = name.lower()
        if "expert_dequant" in low:
            groups["expert_dequant_ms"] += ms
        elif any(w in low for w in ("ragged_paged_attention", "mla_attention_kernel", "mla_merge_kernel")):
            groups["attention_ms"] += ms
        elif "grouped_matmul_kernel" in low:
            groups["grouped_matmul_ms"] += ms
        elif "moe_quant_kernel" in low:
            groups["moe_quant_ms"] += ms
        elif any(w in low for w in ("w4a8_kernel", "tile_kernel", "prep_kernel", "act_quant_kernel",
                                    "gemv_kernel<", "w4a8g_kernel", "stream_probe_kernel")):
            groups["quant_matmul_ms"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
            groups["matmul_ms"] += ms
        else:
            groups["other_ms"] += ms
    busy_ms = union_ms(spans)
    tile_ms = sum(ms for name, (ms, _) in per_name.items() if "tile_kernel" in name or "prep_kernel" in name)
    w4a8_ms = union_ms([sp for sp in spans if "w4a8_kernel" in sp[2] or "act_quant_kernel" in sp[2]])
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        device_busy_ms=busy_ms if per_name else None, kernel_sum_ms=sum(groups.values()),
        idle_share=1.0 - busy_ms / (1e3 * wall_s) if per_name else None,
        kernels_per_step=sum(n for _, n in per_name.values()) / steps, **groups, tile_kernel_ms=tile_ms,
        w4a8_ms=w4a8_ms,
        top=[dict(name=name[:90], ms=ms, count=n) for name, (ms, n) in top],
    )


def phase_end_to_end(torch, card):
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops.attention import plain_ragged_paged_attention

    cfg = TINYLLAMA
    L = cfg["num_hidden_layers"]
    tmp = tempfile.mkdtemp(prefix="scalellm_tinyllama_")
    llm = None
    try:
        t0 = time.monotonic()
        nbytes = write_checkpoint(torch, tmp, cfg)
        t_write = time.monotonic() - t0
        runs, modes = {}, {}
        # With CUDA graphs (sync: the main path; async; 4-step decode), then
        # eagerly, each on a fresh engine.
        for mode in SERVES:
            graphs = mode != "eager"
            t0 = time.monotonic()
            llm = serving_llm(tmp, graphs, mode if graphs else "sync")
            torch.cuda.synchronize()
            t_load = time.monotonic() - t0
            engine = llm._handler.engine
            emit(dict(phase=serve_setup("e2e", mode), graphs=graphs, checkpoint_bytes=nbytes,
                      write_s=t_write, load_s=t_load, kv_blocks=engine.block_manager.options.num_blocks,
                      **graph_stats(engine)))
            # K1 exactly once a layer each step.
            runs[mode] = serve(torch, card, "e2e", llm, (attention.ragged_paged_attention_cuda,),
                               lambda T, S, decode_only: {"ragged_paged_attention_cuda": L}, graphs,
                               mode if graphs else "sync")
            after_serve(torch, card, "e2e", mode, llm, runs, modes)
            if graphs:
                engine = None
                close_llm(torch, card, serve_name("e2e", mode), llm)
                llm = None
        compare_serves(card, "e2e", runs["sync"], runs["eager"])
        emit_modes(card, "e2e", runs, modes)

        # One prefill batch and the decode step after it (every sequence one
        # token: the split-KV blocks) through the model twice, over the same
        # weights: the kernel, then the plain attention. The engine's KV cache (most of the card's memory)
        # is freed first, to leave room for the plain version's gathered
        # copies of K and V.
        model = engine.model
        tok = llm._handler.tokenizer
        engine = None
        close_llm(torch, card, "e2e_eager", llm)
        llm = None
        ps = prompts()
        ids = [tok.encode(ps[0])[:200], tok.encode(ps[5])]
        prefill, n_pages = batch_inputs(torch, [(t, 0, len(t) + 1) for t in ids])
        decode, _ = batch_inputs(torch, [([7 + i], len(t), len(t) + 1) for i, t in enumerate(ids)])
        n_tok = sum(len(t) for t in ids)
        logits = {}
        with torch.inference_mode():
            for impl in ("kernel", "plain"):
                model.attn_impl = (
                    plain_ragged_paged_attention if impl == "plain" else attention.ragged_paged_attention
                )
                kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=DEVICE)
                # Logits of every real token of the batch, not only the last.
                a = model.logits(model(kv, prefill.to(DEVICE), all_hidden=True)[:n_tok])
                b = model.logits(model(kv, decode.to(DEVICE), decode_only=True)[: len(ids)])
                logits[impl] = (a, b)
                del kv
        model.attn_impl = attention.ragged_paged_attention
        for which, i in (("prefill", 0), ("decode", 1)):
            got, want = logits["kernel"][i], logits["plain"][i]
            diff = (got - want).abs()
            err = diff.max().item()
            same_argmax = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
            emit(dict(phase="e2e_logits", batch=which, tokens=got.shape[0], max_abs_err=err,
                      mean_abs_err=diff.mean().item(), logits_std=want.std().item(),
                      argmax_agreement=same_argmax, tol=LOGITS_TOL))
            if not torch.isfinite(got).all() or not err <= LOGITS_TOL:
                fail(f"{which}: kernel logits differ from plain-attention logits by {err} > {LOGITS_TOL}")
        return main_path_launches(runs)["ragged_paged_attention_cuda"], runs["async"]["figures"]["kv_blocks"]
    finally:
        if llm is not None:
            llm.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ phase 5


def gptq_checkpoint_tensors(cfg):
    """(HF name, safetensors dtype, shape, kind) of every tensor of a GPTQ
    int4 Llama checkpoint: the projections as qweight i32 [K/8, N], qzeros
    i32 [K/G, N/8] and f16 scales [K/G, N]; embeddings, norms and the
    lm_head in bf16."""
    D, F_, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    Dh = D // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    G = cfg["quantization_config"]["group_size"]
    out = [("model.embed_tokens.weight", "BF16", (V, D), "weight")]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        for name, K, N in (("self_attn.q_proj", D, Hq), ("self_attn.k_proj", D, Hkv),
                           ("self_attn.v_proj", D, Hkv), ("self_attn.o_proj", Hq, D),
                           ("mlp.gate_proj", D, F_), ("mlp.up_proj", D, F_),
                           ("mlp.down_proj", F_, D)):
            out += [(p + name + ".qweight", "I32", (K // 8, N), "qweight"),
                    (p + name + ".qzeros", "I32", (K // G, N // 8), "qzeros"),
                    (p + name + ".scales", "F16", (K // G, N), "scales")]
        out += [(p + "input_layernorm.weight", "BF16", (D,), "norm"),
                (p + "post_attention_layernorm.weight", "BF16", (D,), "norm")]
    out += [("model.norm.weight", "BF16", (D,), "norm"),
            ("lm_head.weight", "BF16", (V, D), "weight")]
    return out


def write_gptq_checkpoint(torch, path, cfg):
    """config.json, tokenizer.json and model.safetensors of a symmetric GPTQ
    checkpoint, generated on the card from a seeded generator: uniformly
    random nibbles, zero point 8 (stored as 7), scales that give the
    dequantized weights a std of about 0.02, bf16 weights N(0, 0.02), norms
    1. Returns the bytes of tensor data."""
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(char_tokenizer_json(), f)
    tensors = gptq_checkpoint_tensors(cfg)
    width = {"BF16": 2, "F16": 2, "I32": 4}
    header, offset = {}, 0
    for name, dtype, shape, _ in tensors:
        n = width[dtype]
        for d in shape:
            n *= d
        header[name] = {"dtype": dtype, "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, dtype, shape, kind in tensors:
            n = header[name]["data_offsets"][1] - header[name]["data_offsets"][0]
            if kind == "norm":
                t = torch.ones(shape, dtype=torch.bfloat16)
            elif kind == "weight":
                t = (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
            elif kind == "qweight":
                t = torch.randint(-128, 128, (n,), generator=gen, device=DEVICE, dtype=torch.int8)
            elif kind == "qzeros":
                t = torch.full((n,), 0x77, dtype=torch.uint8)
            else:
                t = ((torch.rand(shape, generator=gen, device=DEVICE) + 0.5) * (0.02 / 4.6)).to(torch.float16)
            f.write(memoryview(t.cpu().contiguous().view(torch.uint8).numpy().reshape(-1)))
    return offset


# The phases' serving envelope: a 512-token step budget (chunked prefill
# on), 8 sequences a step, contexts of up to 1024 tokens (the 600-char
# prompts plus 32 tokens fit).
SERVE_ENVELOPE = dict(max_tokens_per_batch=512, max_seqs_per_batch=8, max_context_len=1024)


# The serves of phases 4-7 with CUDA graphs, each on a fresh engine: "sync"
# (one step at a time), "async" (the default:
# one step in flight, its pending tokens merged on the card) and "ms4"
# (num_decode_steps=4: a decode-only batch runs 4 micro-steps in one graph
# replay; async on, as the reference defaults it). The eager serve is "sync"
# without graphs.
MODES = {"sync": dict(enable_async_scheduling=False), "async": dict(enable_async_scheduling=True),
         "ms4": dict(num_decode_steps=4)}


def serving_llm(path, graphs, mode="sync", **kw):
    """An LLM for `path` on the card at SERVE_ENVELOPE, stepping as `mode`
    (MODES) asks. With graphs, every engine step replays a CUDA graph of its
    bucket, and the "full" warmup captures every bucket of the envelope at
    init (with "ms4", also the 4-step graph of every decode bucket);
    without, every step runs eagerly. warmup_mode and max_context_len are
    fields of LLMHandlerOptions that LLM does not take (nor does the
    reference's LLM), so its handler is built from the options here. One
    request-handling thread enqueues the prompts in the order given (several
    race), so that two serves of the same traffic build the same batches."""
    from scalellm_tpu_torch import LLM
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions

    llm = LLM.__new__(LLM)
    llm._handler = LLMHandler(LLMHandlerOptions(
        model_path=path, devices=DEVICE, enable_cuda_graph=graphs, warmup_mode="full" if graphs else "off",
        num_handling_threads=1, **{**SERVE_ENVELOPE, **MODES[mode], **kw}))
    return llm


# What a closed engine may leave cached in the caching allocator, free blocks
# that an empty_cache would hand back: above it, the next engine's loads
# would land in them and its KV cache would be sized without them.
CLOSED_SLACK_BYTES = 2**30


def close_llm(torch, card, tag, llm, close=None):
    """Close `llm` (with `close`, by default llm.close) and emit the device memory left after it: what live
    tensors hold (allocated; a caller may keep the model), what the caching
    allocator reserves, what one more empty_cache hands back (released: the
    closed engine's blocks that its close kept cached) and what the device
    reports free. Fails if released exceeds CLOSED_SLACK_BYTES. What stays
    reserved beyond allocated after that is free space inside segments that
    hold live tensors (the kept model's), which no close can return."""
    (close or llm.close)()
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    released = reserved - torch.cuda.memory_reserved()
    free, total = torch.cuda.mem_get_info()
    emit(dict(phase=f"{tag}_closed", allocated_bytes=allocated, reserved_bytes=reserved, released_bytes=released,
              free_bytes=free, total_bytes=total, card=card["nvidia_smi"]))
    if released > CLOSED_SLACK_BYTES:
        fail(f"{tag}: a closed engine left {released / 2**30:.2f} GiB cached in the caching allocator")


def all_counters():
    """Every kernel wrapper of the port; each counts its launches."""
    from scalellm_tpu_torch.ops import attention, quant_mlp
    from scalellm_tpu_torch.ops import quant_matmul as Q

    wrappers = (attention.ragged_paged_attention_cuda, Q.quant_gemv_cuda, Q.quant_w4a8_gemv_cuda,
                Q.quant_stream_probe_cuda, quant_mlp.quant_mlp_cuda) + moe_counters()
    return tuple({w.__name__: w for w in wrappers}.values())


def count_captured_launches():
    """Make every StepGraphs capture note, on the captured step, how far
    each kernel wrapper's counter advanced while the graph was recorded:
    the launches each replay of it makes (for a multi-step graph, those of
    all its micro-steps). A wrapper counts when it is called, which for a
    graph is at the capture; a replay launches the recorded kernels without
    calling the wrappers."""
    from scalellm_tpu_torch.engine.executor import StepGraphs

    real = StepGraphs.record
    if getattr(real, "counts_launches", False):
        return

    def record(self, step):
        counters = all_counters()
        before = [c.launches for c in counters]
        real(self, step)
        step.launches = {c.__name__: c.launches - b for c, b in zip(counters, before)}

    record.counts_launches = True
    StepGraphs.record = record


def watch_steps(engine, counters):
    """Record, per engine dispatch (Executor.execute, one step, or
    execute_multi, N decode micro-steps), the padded token and sequence
    counts, whether it was decode-only, how many times a step's kernels ran
    on the device (the micro-steps, times 2 for a dispatch that captured its
    graph on the card: the eager run before the capture, then the replay),
    and how often each kernel wrapper's kernel was launched: what the
    wrappers counted (an eager dispatch; the eager run and the recording of
    a capture, whose count equals its replay's), plus, for a dispatch that
    replayed an earlier capture, the launches noted at that capture
    (count_captured_launches). Also each dispatch's sampled token ids of the
    real sequences (device tensors, [N, S] for N micro-steps), the host
    clock at each dispatch's start and each dispatch's micro-steps.
    Returns (log, sampled, starts, micro)."""
    log, sampled, starts, micro = [], [], [], []
    ex = engine.executor

    def watched(real, multi):
        def run(mi, si, *args, **kw):
            starts.append(time.monotonic())
            before = [c.launches for c in counters]
            known = set(ex.graphs.graphs) if ex.graphs is not None else set()
            out = real(mi, si, *args, **kw)
            got = [c.launches - b for c, b in zip(counters, before)]
            n = (args[0] if args else kw["num_steps"]) if multi else 1
            runs = n
            if ex.graphs is not None:
                if ex.graphs.last_key in known:
                    recorded = getattr(ex.graphs.graphs[ex.graphs.last_key], "launches", {})
                    got = [k + recorded.get(c.__name__, 0) for k, c in zip(got, counters)]
                elif ex.graphs.cuda:
                    runs = 2 * n
            decode_only = True if multi else kw.get("decode_only", args[0] if args else False)
            log.append((mi.token_ids.shape[0], mi.selected_idxes.shape[0], decode_only, runs, *got))
            sampled.append(out.next_tokens[..., : int(mi.num_seqs[0])])
            micro.append(n)
            return out
        return run

    ex.execute = watched(ex.execute, False)
    ex.execute_multi = watched(ex.execute_multi, True)
    return log, sampled, starts, micro


def unwatch_steps(engine):
    """Remove the wrappers of watch_steps."""
    for name in ("execute", "execute_multi"):
        engine.executor.__dict__.pop(name, None)


def graph_stats(engine):
    """The engine's step graphs: how many (multi-step ones apart), the
    seconds spent capturing them (each capture's eager run included) and the
    bytes of their memory pool."""
    g = engine.executor.graphs
    if g is None:
        return dict(graphs_captured=0, multi_step_graphs=0, capture_s=0.0, graph_pool_bytes=0)
    return dict(graphs_captured=len(g.graphs), multi_step_graphs=sum(1 for k in g.graphs if len(k) > 4),
                capture_s=g.capture_s, graph_pool_bytes=g.pool_bytes())


def record_outputs(llm):
    """Make the scheduler note each finished request's prompt and generated
    ids (the output's token_ids hold only the ids that decode to text) by
    prompt text. Returns the dict it fills."""
    sched = llm._handler.scheduler
    real, ids = sched._finish_request, {}

    def finish(request):
        seq = request.sequences[0]
        ids[request.prompt] = (list(seq.token_ids[: seq.num_prompt_tokens]),
                               list(seq.token_ids[seq.num_prompt_tokens :]))
        real(request)

    sched._finish_request = finish
    return ids


def serve(torch, card, tag, llm, counters, want, graphs, mode="sync", lora=None, traffic=None, profiled=True):
    """The phase's traffic through `llm`: a warm-up request, then one timed
    generate of the 8 prompts (32 greedy tokens each; `traffic(seed)`, when
    given, returns other (prompts, SamplingParams list): a request without
    ignore_eos then ends anywhere from 1 to its max_tokens; profiled=False
    skips the profiled run and its line) with every dispatch's
    launches held to want(T, S, decode_only) (launches by wrapper name)
    times the dispatch's device runs of a step (micro-steps included), then
    the same traffic with other text under torch.profiler (the idle share is
    taken against the timed run's wall). Emits `{tag}_e2e` and
    `{tag}_profile` (`{tag}_eager_...` without graphs, `{tag}_async_...` and
    `{tag}_ms4_...` for those modes). lora: the LoRA adapter name of each
    of the 8 requests (phase 20), both times. Returns the outputs, each
    dispatch's sampled ids, each request's prompt and generated ids, the
    launches by wrapper name and the figures the comparison lines hold."""
    from torch.profiler import ProfilerActivity, profile

    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS, STEP_COUNTERS

    name = (tag if mode == "sync" else f"{tag}_{mode}") if graphs else f"{tag}_eager"
    engine = llm._handler.engine
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    traffic = traffic or (lambda seed: (prompts(seed), greedy))
    llm.generate(["warm up the engine"], SamplingParams(max_tokens=2, temperature=0.0))
    ps, sps = traffic(SEED)
    sp_of = dict(zip(ps, sps)) if isinstance(sps, list) else {p: sps for p in ps}
    ttft = HISTOGRAMS.get("time_to_first_token_latency_seconds")
    ttft_before = (ttft.total, ttft.count)
    steps_log, sampled, starts, micro = watch_steps(engine, counters)
    ids = record_outputs(llm)
    compiles = COUNTERS.get("num_mid_serve_compiles")
    steps_before = {c: COUNTERS.get(c) for c in STEP_COUNTERS}
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = llm.generate(ps, sps, lora=lora)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    compiles = COUNTERS.get("num_mid_serve_compiles") - compiles
    step_counts = {c: COUNTERS.get(c) - v for c, v in steps_before.items()}
    ttft = HISTOGRAMS.get("time_to_first_token_latency_seconds")
    mean_ttft = (ttft.total - ttft_before[0]) / max(ttft.count - ttft_before[1], 1)
    if len(outs) != len(ps) or sorted(ids) != sorted(ps):
        fail(f"{name}: {len(outs)} of {len(ps)} requests returned")
    # Generated tokens are counted from usage: the char tokenizer names
    # ids below 256 only, and the output's token_ids hold only the ids
    # that decoded to text (the random model mostly picks higher ids).
    for p, o in zip(ps, outs):
        sp = sp_of[p]
        n = o.usage.num_generated_tokens if o.usage else 0
        if not (o.finished and o.status.ok and (n == sp.max_tokens if sp.ignore_eos else 1 <= n <= sp.max_tokens)):
            fail(f"{name}: request did not finish with {sp.max_tokens} tokens: {o.status}, {o.usage}")
        if len(ids[p][1]) != n or min(ids[p][1]) < 0:
            fail(f"{name}: a request's generated ids are not {n} resolved tokens")
    if not steps_log:
        fail(f"{name}: no engine step ran")
    if graphs and compiles:
        fail(f"{name}: {compiles} graphs were captured inside the timed generate")
    names = [c.__name__ for c in counters]
    per_step = {}
    for (T, S, decode_only, runs, *got), n in zip(steps_log, micro):
        step_want = want(T, S, decode_only)
        expected = [runs * step_want.get(k, 0) for k in names]
        if got != expected:
            fail(f"{name}: a dispatch of T={T}, S={S}, decode_only={decode_only}, {n} micro-steps ({runs} "
                 f"device runs of a step) launched {dict(zip(names, got))}, expected {dict(zip(names, expected))}")
        per_step[f"T={T},S={S},decode_only={decode_only}"] = {k: v for k, v in step_want.items() if v}
    launches = {k: sum(st[4 + i] for st in steps_log) for i, k in enumerate(names)}
    tokens = [t.cpu() for t in sampled]
    n_tokens = sum(o.usage.num_generated_tokens for o in outs)
    # Host wall a dispatch: from its start to the next one's (the last to
    # the generate's end), decode-only dispatches and the others apart.
    spans = [(b - a) * 1e3 for a, b in zip(starts, starts[1:] + [t0 + wall])]
    decode_ms = [ms for ms, st in zip(spans, steps_log) if st[2]]
    other_ms = [ms for ms, st in zip(spans, steps_log) if not st[2]]
    result = dict(graphs=graphs, mode=mode, output_tok_per_s=n_tokens / wall, mean_ttft_s=mean_ttft, wall_s=wall,
                  engine_steps=len(steps_log), multi_step_dispatches=sum(1 for n in micro if n > 1),
                  **{c: step_counts[c] for c in ("num_engine_steps", "num_async_steps", "num_multi_steps")},
                  host_ms_per_dispatch=wall * 1e3 / len(steps_log), host_ms_per_token=wall * 1e3 / n_tokens,
                  decode_step_ms=statistics.median(decode_ms) if decode_ms else None,
                  other_step_ms=statistics.fmean(other_ms) if other_ms else None,
                  mid_serve_compiles=compiles, kv_blocks=engine.block_manager.options.num_blocks,
                  **graph_stats(engine))
    line = dict(phase=f"{name}_e2e", requests=len(outs), output_tokens=n_tokens,
                decode_only_steps=sum(1 for st in steps_log if st[2]),
                prefill_steps=sum(1 for st in steps_log if st[0] > 64),
                captured_in_serve=sum(1 for st, n in zip(steps_log, micro) if st[3] == 2 * n),
                step_tokens=sorted({st[0] for st in steps_log}),
                launches={k: v for k, v in launches.items() if v}, per_step=per_step)

    del steps_log[:], micro[:]
    breakdown = dict(idle_share=None, kernels_per_step=None, device_busy_ms=None)
    if profiled:
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            llm.generate(*traffic(SEED + 1), lora=lora)
            torch.cuda.synchronize()
        profiled_wall = time.monotonic() - t0
        breakdown = device_breakdown(prof, wall, len(steps_log))
        del prof
    unwatch_steps(engine)
    llm._handler.scheduler.__dict__.pop("_finish_request", None)  # record_outputs' wrapper
    result.update(idle_share=breakdown["idle_share"], kernels_per_step=breakdown["kernels_per_step"],
                  device_busy_ms=breakdown["device_busy_ms"])
    emit(dict(line, **result, card=card["nvidia_smi"]))
    if profiled:
        emit(dict(phase=f"{name}_profile", graphs=graphs, mode=mode, engine_steps=len(steps_log),
                  profiled_wall_s=profiled_wall, unprofiled_wall_s=wall, **breakdown, card=card["nvidia_smi"]))
    return dict(outs=outs, tokens=tokens, ids=ids, launches=launches, figures=result)


def teacher_forced_gap(torch, model, prompt_ids, generated, lora=None):
    """The largest gap, over the generated positions, between a position's
    largest logit and the logit of the token generated there, from one
    prefill of prompt + output through `model` (its kernels; `lora`: the
    LoRA adapter slot it runs under): 0 for a greedy choice, within
    LOGITS_TOL for one that kernel rounding can explain."""
    ids = prompt_ids + generated
    mi, n_pages = batch_inputs(torch, [(ids, 0, len(ids) + 1)], lora=None if lora is None else [lora])
    with torch.inference_mode():
        kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.kv_cache_dtype(), device=DEVICE)
        rows = model(kv, mi.to(DEVICE), all_hidden=True)[len(prompt_ids) - 1 : len(ids) - 1]
        logits = model.logits(rows).float()
        chosen = logits.gather(1, torch.tensor(generated, device=DEVICE)[:, None])[:, 0]
        return (logits.max(-1).values - chosen).max().item()


def check_mode(torch, tag, mode, model, sync_run, run, exact=False, slots=None):
    """Hold a mode's serve to a sync serve (phases 4-7: the sync serve with
    graphs), request by request: the same generated ids, or, where they
    differ (the serves need not build the same steps: async skips a
    sequence whose pending token reaches its limit, and K1's and K9's split
    plans depend on S and the block table's width), every token of the
    mode's a greedy choice up to kernel rounding (teacher_forced_gap within
    LOGITS_TOL, through `model`). With exact, any request whose ids differ
    fails. Fails unless the mode took its dispatches (num_async_steps,
    num_multi_steps). slots: each prompt's LoRA adapter slot (phase 20).
    Returns the figures of the `{tag}_modes` line."""
    differing, gaps = [], []
    for prompt, (prompt_ids, gen) in run["ids"].items():
        if gen != sync_run["ids"][prompt][1]:
            differing.append(prompt)
            gaps.append(teacher_forced_gap(torch, model, prompt_ids, gen,
                                           None if slots is None else slots[prompt]))
    figures = run["figures"]
    out = dict(requests_differing=len(differing), largest_gap=max(gaps, default=0.0), tol=LOGITS_TOL,
               **{k: figures[k] for k in ("output_tok_per_s", "mean_ttft_s", "engine_steps", "num_async_steps",
                                          "num_multi_steps", "host_ms_per_dispatch", "host_ms_per_token",
                                          "idle_share", "mid_serve_compiles", "graphs_captured",
                                          "multi_step_graphs", "graph_pool_bytes")})
    if any(not g <= LOGITS_TOL for g in gaps):
        fail(f"{tag} {mode}: a request's tokens differ from the sync serve's by more than kernel rounding "
             f"(largest gap {max(gaps)} > {LOGITS_TOL})")
    if exact and differing:
        fail(f"{tag} {mode}: {len(differing)} of {len(run['ids'])} requests got other ids than the sync serve's "
             f"(largest gap {max(gaps)})")
    key = {"async": "num_async_steps", "ms4": "num_multi_steps"}[mode]
    if not figures[key] > 0:
        fail(f"{tag} {mode}: the serve took no {key}")
    return out


def check_fetch_overlap(torch, card, tag, engine):
    """Finalizing a dispatched step waits for that step alone: with the
    next step dispatched and a device spin enqueued after it, the first
    step's fetch must return while the spin still runs."""
    from scalellm_tpu_torch.engine.executor import HostOutputs, minimal_inputs, minimal_sampling_inputs

    ex = engine.executor
    mi, si = minimal_inputs(16, 1, 4), minimal_sampling_inputs(1)  # KV on the reserved page 0
    torch.cuda.synchronize()
    first = HostOutputs(ex.execute(mi, si, decode_only=True), logprobs=True)
    ex.execute(mi, si, decode_only=True)
    torch.cuda._sleep(FETCH_SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    t0 = time.monotonic()
    first.wait()
    wait_ms = (time.monotonic() - t0) * 1e3
    returned_during_spin = not spun.query()
    t0 = time.monotonic()
    torch.cuda.synchronize()
    emit(dict(phase=f"{tag}_fetch_overlap", returned_during_spin=returned_during_spin, fetch_wait_ms=wait_ms,
              spin_left_ms=(time.monotonic() - t0) * 1e3, card=card["nvidia_smi"]))
    if not returned_during_spin:
        fail(f"{tag}: finalizing a step waited for work enqueued after the next step's dispatch")


def compare_serves(card, tag, with_graphs, eager):
    """Emit the graphs/eager line of a phase (both serves' figures, from the
    same call), and fail unless both serves sampled the same token ids at
    every step and gave the same texts."""
    same_ids = (len(with_graphs["tokens"]) == len(eager["tokens"])
                and all(a.equal(b) for a, b in zip(with_graphs["tokens"], eager["tokens"])))
    same_text = [o.outputs[0].text for o in with_graphs["outs"]] == [o.outputs[0].text for o in eager["outs"]]
    emit(dict(phase=f"{tag}_graphs_vs_eager", same_token_ids=same_ids, same_text=same_text,
              graphs=with_graphs["figures"], eager=eager["figures"], card=card["nvidia_smi"]))
    if not (same_ids and same_text):
        fail(f"{tag}: the serve with CUDA graphs sampled other token ids than the eager serve")


# A phase's serves, in order: the three modes with CUDA graphs, then eager.
SERVES = ("sync", "async", "ms4", "eager")
# Phases 8 and 9 serve twice: the default (async, graphs), then eager (sync).
MOE_SERVES = ("async", "eager")


def serve_name(tag, mode):
    """A serve's name, which prefixes its lines: the sync serve's is the tag."""
    return tag if mode == "sync" else f"{tag}_{mode}"


def serve_setup(tag, mode):
    """The name of a serve's setup line."""
    return f"{serve_name(tag, mode)}_setup"


def after_serve(torch, card, tag, mode, llm, runs, modes):
    """What a phase checks on a serve's engine before it is closed: the
    async and ms4 serves against the sync one (check_mode, through the
    serve's model), and, in phase 4, the async engine's fetch
    (check_fetch_overlap)."""
    if mode in ("async", "ms4") and "sync" in runs:
        modes[mode] = check_mode(torch, tag, mode, llm._handler.engine.model, runs["sync"], runs[mode])
    if mode == "async" and tag == "e2e":
        check_fetch_overlap(torch, card, tag, llm._handler.engine)


def emit_modes(card, tag, runs, modes):
    """The `{tag}_modes` line: the sync serve with graphs and, beside it,
    the async and ms4 serves' figures and how many requests differed from
    it (and the largest teacher-forced gap of those), from the same call."""
    sync = runs["sync"]["figures"]
    emit(dict(phase=f"{tag}_modes", sync={k: sync[k] for k in (
        "output_tok_per_s", "mean_ttft_s", "engine_steps", "host_ms_per_dispatch", "host_ms_per_token",
        "idle_share", "mid_serve_compiles", "graphs_captured", "graph_pool_bytes")}, **modes,
        card=card["nvidia_smi"]))


def main_path_launches(runs):
    """A phase's launches on its main paths: the serves with graphs."""
    out = {}
    for mode in ("sync", "async", "ms4"):
        for k, v in runs.get(mode, {"launches": {}})["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def phase_end_to_end_int4(torch, card, n_layers, keep=False):
    """Phase 5. Returns the launches on its main paths and, with keep, the
    GPTQ checkpoint's directory, left for phase 23 (the caller removes it;
    else None)."""
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops import quant_matmul as Q
    from scalellm_tpu_torch.ops.attention import plain_ragged_paged_attention

    cfg = dict(LLAMA31_8B_INT4, num_hidden_layers=n_layers)
    L = n_layers
    k1, w4a8 = attention.ragged_paged_attention_cuda, Q.quant_matmul_w4a8_cuda
    group, dequant = Q.quant_matmul_group_cuda, Q.quant_matmul_dequant_cuda
    gemv, w4a8g, probe = Q.quant_gemv_cuda, Q.quant_w4a8_gemv_cuda, Q.quant_stream_probe_cuda
    counters = (k1, w4a8, group, dequant, gemv, w4a8g)
    tmp = tempfile.mkdtemp(prefix="scalellm_llama8b_int4_")
    llm = None

    def want(T, S, decode_only):
        # The lm_head sees the padded count of selected rows.
        out = {k1.__name__: L, w4a8.__name__: 0, dequant.__name__: 0}
        out[(dequant if T > 64 else w4a8).__name__] += 4 * L
        out[(dequant if S > 64 else w4a8).__name__] += 1
        return out

    try:
        t0 = time.monotonic()
        nbytes = write_gptq_checkpoint(torch, tmp, cfg)
        t_write = time.monotonic() - t0
        runs, modes = {}, {}
        # With CUDA graphs (sync: the main path; async; 4-step decode), then
        # eagerly, each on a fresh engine; the eager one then serves the
        # variant runs below: their quant_impl hook acts when a step's Python
        # runs, which a replayed graph skips.
        for mode in SERVES:
            graphs = mode != "eager"
            t0 = time.monotonic()
            llm = serving_llm(tmp, graphs, mode if graphs else "sync", quantize_lm_head=True)
            torch.cuda.synchronize()
            t_load = time.monotonic() - t0
            engine = llm._handler.engine
            model = engine.model
            weight_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
            emit(dict(phase=serve_setup("int4", mode), graphs=graphs, layers=L,
                      full_depth=L == LLAMA31_8B_INT4["num_hidden_layers"], checkpoint_bytes=nbytes,
                      write_s=t_write, load_s=t_load, weight_bytes_on_card=weight_bytes,
                      lm_head_bits=model.lm_head.bits, kv_blocks=engine.block_manager.options.num_blocks,
                      **graph_stats(engine)))
            runs[mode] = serve(torch, card, "int4", llm, counters, want, graphs, mode if graphs else "sync")
            after_serve(torch, card, "int4", mode, llm, runs, modes)
            if graphs:
                engine = model = None
                close_llm(torch, card, serve_name("int4", mode), llm)
                llm = None
        compare_serves(card, "int4", runs["sync"], runs["eager"])
        emit_modes(card, "int4", runs, modes)
        launches = main_path_launches(runs)
        ps = prompts()
        steps_log, *_ = watch_steps(engine, counters)

        # The same path through the group kernel, two requests: the model's
        # quantized matmul with variant="group".
        model.quant_impl = functools.partial(Q.quant_matmul, variant="group")
        try:
            for c in counters:
                c.launches = 0
            del steps_log[:]
            short = llm.generate(ps[2:4], SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
        finally:
            model.quant_impl = Q.quant_matmul
        group_launches = group.launches
        if not all(o.finished and o.status.ok for o in short):
            fail("int4: a request of the group-variant run did not finish")
        if any(st[3] != 1 for st in steps_log):
            fail("int4: a step of the eager engine ran more than once")
        if (group_launches != (4 * L + 1) * len(steps_log) or w4a8.launches or dequant.launches
                or k1.launches != L * len(steps_log)):
            fail(f"int4: the group-variant run launched group {group_launches}, w4a8 "
                 f"{w4a8.launches}, dequant {dequant.launches} in {len(steps_log)} steps")
        emit(dict(phase="int4_group_variant", engine_steps=len(steps_log), group_launches=group_launches))
        launches[group.__name__] = group_launches
        launches[k1.__name__] += k1.launches

        # The small-M variants (K12a, K12b), as the reference's QUANT_VARIANT
        # selects them: two requests each. A step of T <= 64 tokens runs
        # the variant in every projection and the lm_head; a step of more
        # runs dequant in the projections and the variant in the lm_head (M
        # = S sequences).
        for i, (variant, wrapper) in enumerate((("gemv", gemv), ("w4a8g", w4a8g))):
            model.quant_impl = functools.partial(Q.quant_matmul, variant=variant)
            try:
                for c in counters:
                    c.launches = 0
                del steps_log[:]
                # Prompts the prefix cache has not seen: a 300-token first step.
                short = llm.generate(prompts(SEED + 2 + i)[4:6],
                                     SamplingParams(max_tokens=8, temperature=0.0, ignore_eos=True))
            finally:
                model.quant_impl = Q.quant_matmul
            if not all(o.finished and o.status.ok and o.usage.num_generated_tokens == 8 for o in short):
                fail(f"int4: a request of the {variant}-variant run did not finish")
            for T, S, _, runs_, *got in steps_log:
                step_want = {k1: L, w4a8: 0, group: 0, dequant: 0, gemv: 0, w4a8g: 0}
                step_want[dequant if T > 64 else wrapper] += 4 * L
                step_want[wrapper] += 1  # S <= 64 here
                if runs_ != 1 or got != [step_want[c] for c in counters]:
                    fail(f"int4: a {variant}-variant step of T={T}, S={S} launched (K1, w4a8, group, "
                         f"dequant, gemv, w4a8g) = {tuple(got)}, expected {tuple(step_want[c] for c in counters)}")
            emit(dict(phase=f"int4_{variant}_variant", engine_steps=len(steps_log),
                      step_tokens=sorted({st[0] for st in steps_log}), launches=wrapper.launches,
                      dequant_launches=dequant.launches))
            launches[wrapper.__name__] = wrapper.launches
            launches[dequant.__name__] += dequant.launches
            launches[k1.__name__] += k1.launches

        # A prefill batch (T = 512: dequant) and the decode step after it
        # (T = 16: w4a8; K1's split-KV blocks) through the model twice over
        # the same weights: the kernels, then the plain versions
        # of all of them.
        tok = llm._handler.tokenizer
        engine = None
        close_llm(torch, card, "int4_eager", llm)
        llm = None
        ids = [tok.encode(ps[0])[:200], tok.encode(ps[5])]
        prefill, n_pages = batch_inputs(torch, [(t, 0, len(t) + 1) for t in ids])
        decode, _ = batch_inputs(torch, [([7 + i], len(t), len(t) + 1) for i, t in enumerate(ids)])
        n_tok = sum(len(t) for t in ids)
        logits = {}
        with torch.inference_mode():
            for impl in ("kernel", "plain"):
                plain = impl == "plain"
                model.attn_impl = plain_ragged_paged_attention if plain else attention.ragged_paged_attention
                model.quant_impl = Q.plain_quant_matmul if plain else Q.quant_matmul
                kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=DEVICE)
                a = model.logits(model(kv, prefill.to(DEVICE), all_hidden=True)[:n_tok])
                b = model.logits(model(kv, decode.to(DEVICE), decode_only=True)[: len(ids)])
                logits[impl] = (a, b)
                del kv
        model.attn_impl, model.quant_impl = attention.ragged_paged_attention, Q.quant_matmul
        for which, i in (("prefill", 0), ("decode", 1)):
            got, want = logits["kernel"][i], logits["plain"][i]
            diff = (got - want).abs()
            err = diff.max().item()
            emit(dict(phase="int4_logits", batch=which, rows=got.shape[0], max_abs_err=err,
                      mean_abs_err=diff.mean().item(), logits_std=want.std().item(),
                      argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                      tol=LOGITS_TOL))
            if not torch.isfinite(got).all() or not err <= LOGITS_TOL:
                fail(f"int4 {which}: kernel logits differ from plain logits by {err} > {LOGITS_TOL}")

        # The decode batch through gemv and w4a8g, kernels against plain
        # versions (the prefill before it fills the KV cache; above 64
        # tokens both variants run dequant there).
        with torch.inference_mode():
            for variant in ("gemv", "w4a8g"):
                out = {}
                for impl in ("kernel", "plain"):
                    fn = Q.plain_quant_matmul if impl == "plain" else Q.quant_matmul
                    model.quant_impl = functools.partial(fn, variant=variant)
                    model.attn_impl = (plain_ragged_paged_attention if impl == "plain"
                                       else attention.ragged_paged_attention)
                    kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=DEVICE)
                    model(kv, prefill.to(DEVICE))
                    out[impl] = model.logits(model(kv, decode.to(DEVICE), decode_only=True)[: len(ids)])
                    del kv
                diff = (out["kernel"] - out["plain"]).abs()
                err = diff.max().item()
                emit(dict(phase="int4_logits", batch="decode", variant=variant, rows=len(ids),
                          max_abs_err=err, mean_abs_err=diff.mean().item(),
                          argmax_agreement=(out["kernel"].argmax(-1) == out["plain"].argmax(-1)).float().mean().item(),
                          tol=LOGITS_TOL))
                if not torch.isfinite(out["kernel"]).all() or not err <= LOGITS_TOL:
                    fail(f"int4 decode, {variant}: kernel logits differ from plain logits by {err} > {LOGITS_TOL}")
        model.attn_impl, model.quant_impl = attention.ragged_paged_attention, Q.quant_matmul

        launches[probe.__name__] = phase_stream_probe_in_model(torch, card, model, prefill, decode, n_pages)
        return launches, tmp if keep else None
    finally:
        if llm is not None:
            llm.close()
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)


def device_ms(prof, *names):
    """Device time (ms) of the kernels whose names contain one of `names`."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() / 1e3 for e in prof.events()
               if e.device_type == DeviceType.CUDA and any(n in e.name for n in names))


def kernel_split(torch, fn, flush, groups, calls=10):
    """Device ms a call of fn, by groups of kernel names ({key: names}),
    under torch.profiler over `calls` calls, L2 flushed before each."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    split = {key: device_ms(prof, *names) / calls for key, names in groups.items()}
    if not all(ms > 0 for ms in split.values()):
        fail(f"kernel split: no device time read for {split}")
    return split


def phase_stream_probe_in_model(torch, card, model, prefill, decode, n_pages):
    """The reference's in-model weight-stream probe (bench.py:487-509): one
    decode step under torch.profiler with the model's quantized matmuls,
    then with every layer projection replaced by the stream probe (the
    lm_head stays real, as in the reference). The layer projections' device
    time against the probe's is the fraction of the stream ceiling the
    decode projections reach. Returns the probe's launches in that step."""
    from torch.profiler import ProfilerActivity, profile

    from scalellm_tpu_torch.ops import quant_matmul as Q

    lm_head = model.lm_head.qweight

    def probe_impl(x, qweight, *args, **kw):
        return Q.quant_matmul(x, qweight, *args, **dict(kw, variant="" if qweight is lm_head else "stream"))

    quant_kernels = ("w4a8_kernel", "act_quant_kernel", "tile_kernel")
    times = {}
    with torch.inference_mode():
        kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=DEVICE)
        model(kv, prefill.to(DEVICE))
        step = decode.to(DEVICE)
        for impl in ("kernels", "probe"):
            model.quant_impl = probe_impl if impl == "probe" else Q.quant_matmul
            model.logits(model(kv, step, decode_only=True))  # warm
            torch.cuda.synchronize()
            Q.quant_stream_probe_cuda.launches = 0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model.logits(model(kv, step, decode_only=True))
                torch.cuda.synchronize()
            times[impl] = dict(quant=device_ms(prof, *quant_kernels), probe=device_ms(prof, "stream_probe_kernel"))
            launches = Q.quant_stream_probe_cuda.launches
        model.quant_impl = Q.quant_matmul
        del kv
    # The probe run's quantized kernels are the lm_head's alone.
    layers_ms = times["kernels"]["quant"] - times["probe"]["quant"]
    probe_ms = times["probe"]["probe"]
    n_layers = len(model.layers)
    want = 4 * n_layers
    if launches != want:
        fail(f"stream probe in model: {launches} probe launches in one step, expected {want}")
    if not probe_ms > 0 or not layers_ms > 0:
        fail(f"stream probe in model: no device time read (layers {layers_ms} ms, probe {probe_ms} ms)")
    proj_bytes = sum(t.numel() * t.element_size() for layer in model.layers
                     for w in (layer.qkv_proj, layer.o_proj, layer.gate_up_proj, layer.down_proj)
                     for t in (w.qweight, w.scales) + ((w.zeros,) if "zeros" in w._buffers else ()))
    emit(dict(phase="int4_stream_probe", tokens=int(decode.token_ids.shape[0]), layers=n_layers,
              projection_bytes=proj_bytes, projections_ms=layers_ms, probe_ms=probe_ms,
              fraction_of_stream_ceiling=probe_ms / layers_ms,
              probe_gb_per_s=proj_bytes / (probe_ms * 1e-3) / 1e9,
              projections_gb_per_s=proj_bytes / (layers_ms * 1e-3) / 1e9,
              lm_head_ms=times["probe"]["quant"], probe_launches=launches, card=card["nvidia_smi"]))
    return launches


# ------------------------------------------------------------------ phase 6


def deepseek_checkpoint_tensors(cfg):
    """(HF name, shape, is norm) of every tensor of a DeepSeek-V2 checkpoint
    without q_lora_rank: a dense first stack, then MoE layers with one
    tensor per routed expert and projection."""
    D, V, H = cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    R, F_, Fm = cfg["kv_lora_rank"], cfg["intermediate_size"], cfg["moe_intermediate_size"]
    Fs = Fm * cfg["n_shared_experts"]
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [
            (p + "input_layernorm.weight", (D,), True),
            (p + "post_attention_layernorm.weight", (D,), True),
            (p + "self_attn.q_proj.weight", (H * (nope + rope), D), False),
            (p + "self_attn.kv_a_proj_with_mqa.weight", (R + rope, D), False),
            (p + "self_attn.kv_a_layernorm.weight", (R,), True),
            (p + "self_attn.kv_b_proj.weight", (H * (nope + vd), R), False),
            (p + "self_attn.o_proj.weight", (D, H * vd), False),
        ]
        if l < cfg["first_k_dense_replace"]:
            out += [(p + "mlp.gate_proj.weight", (F_, D), False), (p + "mlp.up_proj.weight", (F_, D), False),
                    (p + "mlp.down_proj.weight", (D, F_), False)]
            continue
        out.append((p + "mlp.gate.weight", (cfg["n_routed_experts"], D), False))
        for e in range(cfg["n_routed_experts"]):
            q = f"{p}mlp.experts.{e}."
            out += [(q + "gate_proj.weight", (Fm, D), False), (q + "up_proj.weight", (Fm, D), False),
                    (q + "down_proj.weight", (D, Fm), False)]
        out += [(p + "mlp.shared_experts.gate_proj.weight", (Fs, D), False),
                (p + "mlp.shared_experts.up_proj.weight", (Fs, D), False),
                (p + "mlp.shared_experts.down_proj.weight", (D, Fs), False)]
    out += [("model.norm.weight", (D,), True), ("lm_head.weight", (V, D), False)]
    return out


def write_temp_checkpoint(torch, name, cfg, tensors, flag=None, init=None):
    """A checkpoint of `tensors` (write_checkpoint, `init`) written once to a new
    temp dir for the phases that serve it: (dir, bytes, seconds to write).
    Fails before writing where the disk lacks room, naming `flag` where
    one cuts the depth."""
    tmp = tempfile.mkdtemp(prefix=f"scalellm_{name}_")
    size = checkpoint_dtype(torch, cfg)[0].itemsize
    need = sum(size * functools.reduce(lambda a, b: a * b, shape, 1) for _, shape, _ in tensors)
    free = shutil.disk_usage(tmp).free
    if free < need + 2**30:
        shutil.rmtree(tmp, ignore_errors=True)
        fail(f"{name}: the {need / 1e9:.1f} GB checkpoint does not fit the {free / 1e9:.1f} GB free "
             f"under {tmp}" + (f"; {flag} cuts the depth" if flag else ""))
    t0 = time.monotonic()
    nbytes = write_checkpoint(torch, tmp, cfg, tensors, init)
    return tmp, nbytes, time.monotonic() - t0


def mixtral_checkpoint_tensors(cfg):
    """(HF name, shape, is norm) of every tensor of a Mixtral checkpoint:
    attention, the router and one tensor per expert and projection (w1
    gate, w3 up, w2 down) each layer."""
    D, F_, V, E = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["num_local_experts"]
    Dh = D // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [
            (p + "input_layernorm.weight", (D,), True),
            (p + "post_attention_layernorm.weight", (D,), True),
            (p + "self_attn.q_proj.weight", (Hq, D), False),
            (p + "self_attn.k_proj.weight", (Hkv, D), False),
            (p + "self_attn.v_proj.weight", (Hkv, D), False),
            (p + "self_attn.o_proj.weight", (D, Hq), False),
            (p + "block_sparse_moe.gate.weight", (E, D), False),
        ]
        for e in range(E):
            q = f"{p}block_sparse_moe.experts.{e}."
            out += [(q + "w1.weight", (F_, D), False), (q + "w3.weight", (F_, D), False),
                    (q + "w2.weight", (D, F_), False)]
    out += [("model.norm.weight", (D,), True), ("lm_head.weight", (V, D), False)]
    return out


def qwen2_moe_checkpoint_tensors(cfg):
    """(HF name, shape, is norm) of every tensor of a Qwen2-MoE checkpoint:
    attention with its q/k/v biases, the router, one tensor per expert and
    projection, the shared expert and its sigmoid gate, each layer."""
    D, V, E = cfg["hidden_size"], cfg["vocab_size"], cfg["num_experts"]
    Fm, Fs = cfg["moe_intermediate_size"], cfg["shared_expert_intermediate_size"]
    Dh = D // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [
            (p + "input_layernorm.weight", (D,), True),
            (p + "post_attention_layernorm.weight", (D,), True),
            (p + "self_attn.q_proj.weight", (Hq, D), False),
            (p + "self_attn.k_proj.weight", (Hkv, D), False),
            (p + "self_attn.v_proj.weight", (Hkv, D), False),
            (p + "self_attn.q_proj.bias", (Hq,), False),
            (p + "self_attn.k_proj.bias", (Hkv,), False),
            (p + "self_attn.v_proj.bias", (Hkv,), False),
            (p + "self_attn.o_proj.weight", (D, Hq), False),
            (p + "mlp.gate.weight", (E, D), False),
        ]
        for e in range(E):
            q = f"{p}mlp.experts.{e}."
            out += [(q + "gate_proj.weight", (Fm, D), False), (q + "up_proj.weight", (Fm, D), False),
                    (q + "down_proj.weight", (D, Fm), False)]
        out += [(p + "mlp.shared_expert.gate_proj.weight", (Fs, D), False),
                (p + "mlp.shared_expert.up_proj.weight", (Fs, D), False),
                (p + "mlp.shared_expert.down_proj.weight", (D, Fs), False),
                (p + "mlp.shared_expert_gate.weight", (1, D), False)]
    out += [("model.norm.weight", (D,), True), ("lm_head.weight", (V, D), False)]
    return out


def gemma2_checkpoint_tensors(cfg):
    """(HF name, shape, is norm) of every tensor of a Gemma2 checkpoint:
    attention at its explicit head dim, the gated MLP, the four norms of a
    layer (input, post-attention, pre- and post-feedforward), tied
    embeddings (no lm_head)."""
    D, F_, V, Dh = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [(p + name + ".weight", (D,), True) for name in (
            "input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm", "post_feedforward_layernorm")]
        out += [
            (p + "self_attn.q_proj.weight", (Hq, D), False),
            (p + "self_attn.k_proj.weight", (Hkv, D), False),
            (p + "self_attn.v_proj.weight", (Hkv, D), False),
            (p + "self_attn.o_proj.weight", (D, Hq), False),
            (p + "mlp.gate_proj.weight", (F_, D), False),
            (p + "mlp.up_proj.weight", (F_, D), False),
            (p + "mlp.down_proj.weight", (D, F_), False),
        ]
    return out + [("model.norm.weight", (D,), True)]


def qwen3_checkpoint_tensors(cfg):
    """(HF name, shape, is norm) of every tensor of a Qwen3 checkpoint: a
    Llama checkpoint at the explicit head dim with the q and k norms of
    each layer ([head_dim])."""
    D, F_, V, Dh = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"], cfg["head_dim"]
    Hq, Hkv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{l}."
        out += [
            (p + "input_layernorm.weight", (D,), True),
            (p + "post_attention_layernorm.weight", (D,), True),
            (p + "self_attn.q_proj.weight", (Hq, D), False),
            (p + "self_attn.k_proj.weight", (Hkv, D), False),
            (p + "self_attn.v_proj.weight", (Hkv, D), False),
            (p + "self_attn.q_norm.weight", (Dh,), True),
            (p + "self_attn.k_norm.weight", (Dh,), True),
            (p + "self_attn.o_proj.weight", (D, Hq), False),
            (p + "mlp.gate_proj.weight", (F_, D), False),
            (p + "mlp.up_proj.weight", (F_, D), False),
            (p + "mlp.down_proj.weight", (D, F_), False),
        ]
    return out + [("model.norm.weight", (D,), True), ("lm_head.weight", (V, D), False)]


def phi_checkpoint_tensors(cfg):
    """(HF name, shape, is a constant) of every tensor of a Phi checkpoint:
    q/k/v, dense (o), fc1 (up) and fc2 (down) with their biases, one
    LayerNorm a layer (the parallel residual), the final LayerNorm, the
    untied lm_head and its bias; biases are constants (0) beside the norms."""
    D, F_, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    out = [("model.embed_tokens.weight", (V, D), False)]
    for l in range(layers_of(cfg)):
        p = f"model.layers.{l}."
        for name in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.dense"):
            out += [(p + name + ".weight", (D, D), False), (p + name + ".bias", (D,), True)]
        out += [(p + "mlp.fc1.weight", (F_, D), False), (p + "mlp.fc1.bias", (F_,), True),
                (p + "mlp.fc2.weight", (D, F_), False), (p + "mlp.fc2.bias", (D,), True),
                (p + "input_layernorm.weight", (D,), True), (p + "input_layernorm.bias", (D,), True)]
    return out + [("model.final_layernorm.weight", (D,), True), ("model.final_layernorm.bias", (D,), True),
                  ("lm_head.weight", (V, D), False), ("lm_head.bias", (V,), True)]


def mpt_checkpoint_tensors(cfg):
    """(HF name, shape, is a constant) of every tensor of an MPT checkpoint
    with no_bias: the fused Wqkv, out_proj, the ungated FFN, bias-free
    LayerNorms, tied embeddings."""
    D, V = cfg["d_model"], cfg["vocab_size"]
    F_ = cfg["expansion_ratio"] * D
    out = [("transformer.wte.weight", (V, D), False)]
    for l in range(layers_of(cfg)):
        p = f"transformer.blocks.{l}."
        out += [(p + "norm_1.weight", (D,), True), (p + "attn.Wqkv.weight", (3 * D, D), False),
                (p + "attn.out_proj.weight", (D, D), False), (p + "norm_2.weight", (D,), True),
                (p + "ffn.up_proj.weight", (F_, D), False), (p + "ffn.down_proj.weight", (D, F_), False)]
    return out + [("transformer.norm_f.weight", (D,), True)]


def bloom_checkpoint_tensors(cfg):
    """(HF name, shape, is a constant) of every tensor of a BLOOM checkpoint:
    the embedding LayerNorm, per layer the per-head interleaved
    query_key_value, dense (o), dense_h_to_4h / dense_4h_to_h with their
    biases and two LayerNorms, the final LayerNorm, tied embeddings."""
    D, V = cfg["hidden_size"], cfg["vocab_size"]
    out = [("transformer.word_embeddings.weight", (V, D), False),
           ("transformer.word_embeddings_layernorm.weight", (D,), True),
           ("transformer.word_embeddings_layernorm.bias", (D,), True)]
    for l in range(layers_of(cfg)):
        p = f"transformer.h.{l}."
        out += [(p + "input_layernorm.weight", (D,), True), (p + "input_layernorm.bias", (D,), True),
                (p + "self_attention.query_key_value.weight", (3 * D, D), False),
                (p + "self_attention.query_key_value.bias", (3 * D,), True),
                (p + "self_attention.dense.weight", (D, D), False), (p + "self_attention.dense.bias", (D,), True),
                (p + "post_attention_layernorm.weight", (D,), True), (p + "post_attention_layernorm.bias", (D,), True),
                (p + "mlp.dense_h_to_4h.weight", (4 * D, D), False), (p + "mlp.dense_h_to_4h.bias", (4 * D,), True),
                (p + "mlp.dense_4h_to_h.weight", (D, 4 * D), False), (p + "mlp.dense_4h_to_h.bias", (D,), True)]
    return out + [("transformer.ln_f.weight", (D,), True), ("transformer.ln_f.bias", (D,), True)]


def gpt2_checkpoint_tensors(cfg):
    """(HF name, shape, is a constant) of every tensor of a GPT-2 checkpoint:
    token and position embeddings, per layer c_attn (q | k | v), c_proj,
    c_fc and the MLP's c_proj as Conv1D weights [in, out] with their biases,
    two LayerNorms, the final LayerNorm, tied embeddings."""
    D, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    out = [("transformer.wte.weight", (V, D), False), ("transformer.wpe.weight", (P, D), False)]
    for l in range(layers_of(cfg)):
        p = f"transformer.h.{l}."
        out += [(p + "ln_1.weight", (D,), True), (p + "ln_1.bias", (D,), True),
                (p + "attn.c_attn.weight", (D, 3 * D), False), (p + "attn.c_attn.bias", (3 * D,), True),
                (p + "attn.c_proj.weight", (D, D), False), (p + "attn.c_proj.bias", (D,), True),
                (p + "ln_2.weight", (D,), True), (p + "ln_2.bias", (D,), True),
                (p + "mlp.c_fc.weight", (D, 4 * D), False), (p + "mlp.c_fc.bias", (4 * D,), True),
                (p + "mlp.c_proj.weight", (4 * D, D), False), (p + "mlp.c_proj.bias", (D,), True)]
    return out + [("transformer.ln_f.weight", (D,), True), ("transformer.ln_f.bias", (D,), True)]


def moe_counters():
    """The kernel wrappers a step of phases 6-17 may launch (DeepSeek-V2,
    Mixtral, Qwen2-MoE and the dense DecoderModel families), by name, with
    K1's counts of its ALiBi, head-dim-80, f32 and int8-page launches and
    K9's and K10's of theirs on int8 latent pages."""
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops import grouped_matmul as G
    from scalellm_tpu_torch.ops import mla_attention as M
    from scalellm_tpu_torch.ops import moe_quant as MQ
    from scalellm_tpu_torch.ops import quant_matmul as Q

    k1 = attention.ragged_paged_attention_cuda
    return (k1, k1.alibi, k1.d80, k1.f32, k1.int8, G.grouped_matmul_cuda, MQ.grouped_quant_matmul_pair_cuda,
            MQ.grouped_quant_matmul_cuda, MQ.expert_dequant_cuda, M.mla_decode_attention_cuda,
            M.mla_prefill_attention_cuda, M.mla_decode_attention_cuda.int8, M.mla_prefill_attention_cuda.int8,
            Q.quant_matmul_w4a8_cuda, Q.quant_matmul_group_cuda, Q.quant_matmul_dequant_cuda)


def moe_step_launches(model, T, S, decode_only):
    """What one engine step of T tokens and S selected rows must launch, by
    wrapper name: attention once a layer (DeepSeek: K9 on decode-only steps,
    else K10, each also counted as int8 where the latent pages are;
    DecoderModel: K1, each launch also counted as ALiBi, head dim 80, f32 or
    int8 pages where the model is so); per MoE layer K6
    three times for bf16 experts, and for quantized ones K8 (gate and up)
    and K7 (down) where the T * top_k routed rows take the decode kernel
    (the dispatcher's takes_decode_kernel), else K6 in their place (two for
    the pair, one for down), each after one int4 expert dequantization;
    and each quantized projection's kernel as
    plan() picks it (M = T; the lm_head's M = S)."""
    from scalellm_tpu_torch.models.common import QuantExperts, QuantLinear
    from scalellm_tpu_torch.ops import moe_quant as MQ
    from scalellm_tpu_torch.ops import quant_matmul as Q

    import torch

    a = model.args
    want = {c.__name__: 0 for c in moe_counters()}
    if getattr(model, "mla", False):
        mla = "mla_decode_attention" if decode_only else "mla_prefill_attention"
        want[f"{mla}_cuda"] = a.n_layers
        want[f"{mla}_int8"] = a.n_layers if model.kv_quant else 0
    else:
        want["ragged_paged_attention_cuda"] = a.n_layers
        for kind, on in (("alibi", a.pos_embedding_type == "alibi"), ("d80", a.head_dim == 80),
                         ("f32", model.dtype == torch.float32), ("int8", model.kv_quant)):
            want[f"ragged_paged_attention_{kind}"] = a.n_layers if on else 0
    rows = T * a.n_experts_per_token
    for layer in model.layers:
        if not layer.moe:
            continue
        gate, down = layer.experts_gate, layer.experts_down
        if not isinstance(gate, QuantExperts):
            want["grouped_matmul_cuda"] += 3
            continue
        for w, K, kernel, calls in ((gate, a.hidden_size, "grouped_quant_matmul_pair_cuda", 2),
                                    (down, gate.qweight.shape[1], "grouped_quant_matmul_cuda", 1)):
            if MQ.takes_decode_kernel(rows, K, w.qweight, w.scales):
                want[kernel] += 1
            else:
                want["grouped_matmul_cuda"] += calls
                if w.bits == 4:  # each K6 call on experts dequantized by the kernel
                    want["expert_dequant_cuda"] += calls
    for name, m in model.named_modules():
        if isinstance(m, QuantLinear):
            K = m.qweight.shape[1] * (2 if m.bits == 4 else 1)
            variant = Q.plan(S if name == "lm_head" else T, K, m.qweight.shape[0], m.bits, m.group_size,
                             m.scales.element_size(), False, tile_n=m.tile_n)[0]
            want[f"quant_matmul_{variant}_cuda"] += 1
    return want


def phase_end_to_end_moe(torch, card, name, path, n_layers, full_layers, checkpoint_bytes, quantize="",
                         serves=SERVES, kv_cache_dtype="auto", figures=None, on_engine=None):
    """Serve the checkpoint at `path` with LLM(path, quantize=quantize):
    phase 6 (DeepSeek-V2-Lite, name "deepseek") in bf16 and phase 7 with
    runtime-INT4 experts and projections, each serving SERVES; phases 8
    (Mixtral-8x7B), 9 (Qwen1.5-MoE-A2.7B) and the dense phases 10-15
    (Gemma-2-9B, Qwen3-8B, Phi-2, MPT-7B, BLOOM-560m, GPT-2) the same,
    serving "async" with graphs and then "eager", each request of the async serve held to the eager
    one's ids (a dense model's routing replay below replays nothing); with
    kv_cache_dtype="int8" the same over int8 KV pages (phases 16 and 17).
    Each load must find the checkpoint's bytes free on the card. Fills
    `figures` (where given) with each serve's figures, calls on_engine(tag,
    mode, engine) on each engine before it closes, and returns the launches
    of the serves with graphs."""
    from scalellm_tpu_torch.layers.moe import quant_expert_ffn
    from scalellm_tpu_torch.models.common import QuantExperts
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops import grouped_matmul as G
    from scalellm_tpu_torch.ops import mla_attention as M
    from scalellm_tpu_torch.ops import quant_matmul as Q

    import gc

    tag = (f"{name}_{quantize}" if quantize else name) + ("_int8kv" if kv_cache_dtype == "int8" else "")
    counters = moe_counters()
    gc.collect()  # the previous phase's model, before this one loads
    depth = dict(layers=n_layers, full_depth=n_layers == full_layers)
    llm = None
    try:
        runs, modes = {}, {}
        # With CUDA graphs (the main paths), then eagerly, each on a fresh
        # engine; the routing replay below runs the eager one's model: the
        # replay and recording hooks act when a step's Python runs, which a
        # replayed graph skips.
        for mode in serves:
            graphs = mode != "eager"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            free = torch.cuda.mem_get_info()[0]
            if free < checkpoint_bytes + 2**30:
                fail(f"{tag} {mode}: {free / 1e9:.1f} GB free on the card, the load needs "
                     f"{checkpoint_bytes / 1e9:.1f} GB and more")
            t0 = time.monotonic()
            llm = serving_llm(path, graphs, mode if graphs else "sync", quantize=quantize,
                              kv_cache_dtype=kv_cache_dtype)
            torch.cuda.synchronize()
            t_load = time.monotonic() - t0
            engine = llm._handler.engine
            model = engine.model
            weight_bytes = sum(t.numel() * t.element_size() for t in model.state_dict().values())
            experts = [m for m in model.modules() if isinstance(m, QuantExperts)]
            emit(dict(phase=serve_setup(tag, mode), graphs=graphs, **depth, model_type=model.args.model_type,
                      quantize=quantize or None, free_bytes_before_load=free, load_s=t_load,
                      # the peak of LLM(...): loading, quantizing, the KV cache
                      # (90% of what is left), then the warmup's captures
                      peak_bytes_at_start=torch.cuda.max_memory_allocated(), weight_bytes_on_card=weight_bytes,
                      expert_bits=experts[0].bits if experts else 16,
                      expert_group=experts[0].group_size if experts else None,
                      kv_blocks=engine.block_manager.options.num_blocks,
                      kv_cache_shape=list(engine.executor.kv_cache.shape),
                      kv_cache_dtype=str(engine.executor.kv_cache.dtype), **graph_stats(engine)))
            runs[mode] = serve(torch, card, tag, llm, counters, functools.partial(moe_step_launches, model),
                               graphs, mode if graphs else "sync")
            after_serve(torch, card, tag, mode, llm, runs, modes)
            if on_engine is not None:
                on_engine(tag, mode, engine)
            if graphs:
                engine = model = experts = None
                close_llm(torch, card, serve_name(tag, mode), llm)
                llm = None
        if "sync" in runs:
            compare_serves(card, tag, runs["sync"], runs["eager"])
            emit_modes(card, tag, runs, modes)
        else:
            # The async serve with graphs against the eager one (sync), request
            # by request, through the eager engine's model: the same ids.
            held = check_mode(torch, tag, "async", model, runs["eager"], runs["async"], exact=True)
            emit(dict(phase=f"{tag}_async_vs_eager", **held, eager={k: runs["eager"]["figures"][k] for k in (
                "output_tok_per_s", "mean_ttft_s", "engine_steps", "decode_step_ms", "host_ms_per_token",
                "idle_share", "device_busy_ms")}, card=card["nvidia_smi"]))
        ps = prompts()

        # A prefill batch (K10 or K1; quantized: K4 and the experts through
        # K6) and the decode step after it (K9 or K1; quantized: K2, K8, K7) through the
        # model twice over the same weights: the kernels, then the plain
        # versions. The plain run replays the kernel run's routing, layer by
        # layer: with random weights a near-tie in a router could otherwise
        # send a token to another expert, which is no fault of a kernel.
        tok = llm._handler.tokenizer
        engine = None
        close_llm(torch, card, f"{tag}_eager", llm)
        llm = None
        ids = [tok.encode(ps[0])[:200], tok.encode(ps[5])]
        prefill, n_pages = batch_inputs(torch, [(t, 0, len(t) + 1) for t in ids])
        decode, _ = batch_inputs(torch, [([7 + i], len(t), len(t) + 1) for i, t in enumerate(ids)])
        n_tok = sum(len(t) for t in ids)
        routes, real_router = [], model._router

        def recording(x, w):
            out = real_router(x, w)
            routes.append(out)
            return out

        logits = {}
        attn = ((M.mla_paged_attention, M.plain_mla_paged_attention) if getattr(model, "mla", False)
                else (attention.ragged_paged_attention, attention.plain_ragged_paged_attention))
        # INT4 runs the kernels twice (the second time routing afresh):
        # the two results must be the same bits.
        impls = ("kernel", "kernel_again", "plain") if quantize else ("kernel", "plain")
        with torch.inference_mode():
            for impl in impls:
                plain = impl == "plain"
                model.attn_impl = attn[plain]
                model.gmm_impl = G.plain_grouped_matmul if plain else G.grouped_matmul
                model.quant_impl = Q.plain_quant_matmul if plain else Q.quant_matmul
                model.qexperts_impl = (functools.partial(quant_expert_ffn, variant="plain") if plain
                                       else quant_expert_ffn)
                model._router = ((lambda x, w: routes.pop(0)) if plain
                                 else recording if impl == "kernel" else real_router)
                kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.kv_cache_dtype(), device=DEVICE)
                a = model.logits(model(kv, prefill.to(DEVICE), all_hidden=True)[:n_tok])
                b = model.logits(model(kv, decode.to(DEVICE), decode_only=True)[: len(ids)])
                logits[impl] = (a, b)
                del kv
        if quantize:
            same = [torch.equal(a, b) for a, b in zip(logits["kernel"], logits["kernel_again"])]
            emit(dict(phase=f"{tag}_logits_repeat", batches=["prefill", "decode"], bit_identical=same,
                      max_abs_diff=[(a - b).abs().max().item()
                                    for a, b in zip(logits["kernel"], logits["kernel_again"])]))
            if not all(same):
                fail(f"{tag}: two runs of the same batches through the kernels gave different logits")
        for which, i in (("prefill", 0), ("decode", 1)):
            got, want = logits["kernel"][i], logits["plain"][i]
            diff = (got - want).abs()
            err = diff.max().item()
            emit(dict(phase=f"{tag}_logits", batch=which, rows=got.shape[0], max_abs_err=err,
                      mean_abs_err=diff.mean().item(), logits_std=want.std().item(),
                      argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item(),
                      same_routing=True, tol=LOGITS_TOL))
            if not torch.isfinite(got).all() or not err <= LOGITS_TOL:
                fail(f"{tag} {which}: kernel logits differ from plain logits by {err} > {LOGITS_TOL}")
        if figures is not None:
            figures.update({mode: run["figures"] for mode, run in runs.items()})
        return main_path_launches(runs)
    finally:
        if llm is not None:
            llm.close()


# ------------------------------------------------------------------ phases 16-18

PPL_WINDOW = 512  # tokens a scored window (eval/ppl.py's default)
PPL_WINDOWS = 4
# The int8 cache's blocks against phase 4's bf16 cache in the same memory
# share: half the bytes a slot, so about twice the blocks.
KV_BLOCKS_RATIO = 1.9
PPL_CALIBRATED_SLACK = 1.001  # the reference's check of calibrated against default int8 KV (tests/test_eval.py)
SWAP_POOL_BYTES = 2**30
SWAP_PAGES = 64  # pages of the direct fetch/restore check


def corpus_path():
    """tests/data/corpus.txt of the checkout: the calibration and scoring text."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data", "corpus.txt")


def swap_direct_check(torch, card, tag, engine):
    """KV swap's page moves on a serving engine's cache, checked directly:
    SWAP_PAGES pages (random contents; fewer on a small cache) fetched to
    host memory, restored into other pages and fetched again are the same
    bytes, timed (GB/s of the
    fetch, gather and copy to pinned memory, and of the restore, copy and
    scatter); and a step graph replayed after a restore reads the restored
    pages: a 120-token sequence prefilled into pages 1-8, its decode step
    replayed (a warmed bucket), then the pages fetched, wiped, restored into
    the cache's last 8 pages and the same step replayed over the new block
    table gives the same logits bits. The cache keeps its address."""
    import numpy as np

    from scalellm_tpu_torch.engine.executor import minimal_sampling_inputs

    ex = engine.executor
    kv = ex.kv_cache
    ptr, P = kv.data_ptr(), kv.shape[1]
    n = min(SWAP_PAGES, (P - 1) // 2)  # pages 1..n go to the last n
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 18)
    src = np.arange(1, 1 + n, dtype=np.int32)
    dst = np.arange(P - n, P, dtype=np.int32)
    if kv.dtype == torch.int8:
        kv[:, 1 : 1 + n] = torch.randint(-127, 128, kv[:, 1 : 1 + n].shape, generator=gen, device=DEVICE,
                                         dtype=torch.int8)
    else:
        kv[:, 1 : 1 + n].normal_(generator=gen)
    ex.fetch_pages(src)  # the pinned host allocation made once, outside the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = ex.fetch_pages(src)
    t_fetch = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex.restore_pages(dst, staged)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    again = ex.fetch_pages(dst)
    byte_equal = torch.equal(staged.view(torch.uint8), again.view(torch.uint8)) and torch.equal(
        kv[:, 1 : 1 + n].view(torch.uint8), kv[:, P - n :].view(torch.uint8))

    prompt = torch.randint(1, 200, (120,), generator=gen, device=DEVICE).tolist()
    prefill, _ = batch_inputs(torch, [(prompt, 0, 128)])  # pages 1-8
    with torch.inference_mode():
        ex.execute(prefill, minimal_sampling_inputs(prefill.kv_lens.shape[0]))

    def decode(first_page):
        mi, _ = batch_inputs(torch, [([5], 120, 128)])
        mi.block_tables[0, :8] = torch.arange(first_page, first_page + 8, dtype=torch.int32)
        mi.new_kv_slot_ids[0] = int(mi.block_tables[0, 120 // 16]) * 16 + 120 % 16
        with torch.inference_mode():
            ex.execute(mi, minimal_sampling_inputs(1), decode_only=True)
        return ex.graphs.graphs[ex.graphs.last_key].logits.clone()

    want = decode(1)
    pages = ex.fetch_pages(np.arange(1, 9, dtype=np.int32))
    kv[:, 1:9].zero_()
    ex.restore_pages(np.arange(P - 8, P, dtype=np.int32), pages)
    replays = sum(ex.graphs.replays.values())
    got = decode(P - 8)
    replayed = sum(ex.graphs.replays.values()) == replays + 1
    graph_reads_restored = replayed and torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    nbytes = staged.numel() * staged.element_size()
    emit(dict(phase=f"{tag}_swap_direct", kv_dtype=str(kv.dtype), pages=n, bytes=nbytes,
              fetch_ms=t_fetch * 1e3, restore_ms=t_restore * 1e3, fetch_gb_s=nbytes / t_fetch / 1e9,
              restore_gb_s=nbytes / t_restore / 1e9, byte_equal=byte_equal, replayed=replayed,
              graph_reads_restored=graph_reads_restored, in_place=kv.data_ptr() == ptr, card=card["nvidia_smi"]))
    if not (byte_equal and graph_reads_restored and kv.data_ptr() == ptr):
        fail(f"{tag}: pages fetched and restored are not what was fetched, or a replayed graph did not read them")


def token_nlls(torch, model, ids):
    """Each scored position's next-token NLL over the full PPL_WINDOW windows
    of `ids`, as eval/ppl.py's scorer forms them (f32 [positions])."""
    import dataclasses

    from scalellm_tpu_torch.eval.ppl import _window_inputs, window_cache

    base = _window_inputs(PPL_WINDOW, 16).to(DEVICE)
    kv = window_cache(model, PPL_WINDOW, 16)
    out = []
    with torch.inference_mode():
        for start in range(0, len(ids) - PPL_WINDOW + 1, PPL_WINDOW):
            tokens = torch.tensor(ids[start : start + PPL_WINDOW], dtype=torch.int32, device=DEVICE)
            kv.zero_()
            logits = model.logits(model(kv, dataclasses.replace(base, token_ids=tokens), all_hidden=True))
            logp = torch.log_softmax(logits[:-1].float(), dim=-1)
            out.append(-logp.gather(1, tokens[1:].long()[:, None])[:, 0])
    return torch.cat(out)


def phase_kv_int8(torch, card, bf16_blocks):
    """Phase 16: TinyLlama-1.1B (phase 4's checkpoint and traffic) with
    kv_cache_dtype="int8". Calibrates the per-layer scales with
    eval/kv_calibration.py on tests/data/corpus.txt through the char
    tokenizer (the kv_scales.json sidecar), serves async with graphs and then
    eagerly (phase_end_to_end_moe: the same ids, logits against the plain
    path, K1's int8 launches counted), holds the int8 cache's blocks to at
    least KV_BLOCKS_RATIO times phase 4's, checks KV swap's page moves on
    int8 pages (swap_direct_check), and scores PPL_WINDOWS windows with
    eval/ppl.py: bf16 KV, int8 KV at the default scale, int8 KV calibrated.
    The reference holds the calibrated perplexity to PPL_CALIBRATED_SLACK
    times the default's on a trained model (tests/test_eval.py; the CPU
    test tests/test_torch_eval.py holds the port to it there); on these
    random weights (perplexity above the vocabulary's 32000) the mean NLLs
    differ by less than their noise, so the phase prints that ratio and
    fails instead unless the calibrated scales keep each token's NLL at
    least as close to the bf16-KV one as the default scale does (the mean
    absolute per-token difference, token_nlls). Then GPT-2 (phase 15's checkpoint) served in
    float32 over int8 pages: K1's f32 kernel on int8 pages. Returns the
    launches of the serves with graphs, by model."""
    import gc

    from scalellm_tpu_torch.eval import kv_calibration, ppl
    from scalellm_tpu_torch.tokenizer.tokenizer import load_tokenizer

    cfg = TINYLLAMA
    L = cfg["num_hidden_layers"]
    tmp = tempfile.mkdtemp(prefix="scalellm_tinyllama_int8kv_")
    launches = {}
    try:
        nbytes = write_checkpoint(torch, tmp, cfg)
        t0 = time.monotonic()
        calib = kv_calibration.main(["--model", tmp, "--text", corpus_path(), "--window", str(PPL_WINDOW),
                                     "--max-tokens", str(PPL_WINDOWS * PPL_WINDOW)])
        t_calib = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        with open(calib["out"]) as f:
            sidecar = json.load(f)
        emit(dict(phase="tinyllama_kv_calibration", seconds=t_calib, windows=PPL_WINDOWS, window=PPL_WINDOW,
                  k_scale=sidecar["k"], v_scale=sidecar["v"], card=card["nvidia_smi"]))
        figures = {}

        def check_swap(tag, mode, engine):
            if mode == "async":
                swap_direct_check(torch, card, tag, engine)

        launches["tinyllama"] = phase_end_to_end_moe(torch, card, "tinyllama", tmp, L, L, nbytes, "", MOE_SERVES,
                                                     kv_cache_dtype="int8", figures=figures, on_engine=check_swap)
        blocks = figures["async"]["kv_blocks"]
        emit(dict(phase="tinyllama_int8kv_blocks", int8_kv_blocks=blocks, bf16_kv_blocks=bf16_blocks,
                  ratio=blocks / bf16_blocks, want=KV_BLOCKS_RATIO, card=card["nvidia_smi"]))
        if not blocks >= KV_BLOCKS_RATIO * bf16_blocks:
            fail(f"the int8 KV cache holds {blocks} blocks, not {KV_BLOCKS_RATIO}x phase 4's {bf16_blocks}")

        tok = load_tokenizer(tmp, None)
        with open(corpus_path(), encoding="utf-8") as f:
            ids = tok.encode(f.read())[: PPL_WINDOWS * PPL_WINDOW]
        scores, nlls = {}, {}
        for name, kv in (("bf16_kv", "auto"), ("int8_kv_default_scale", "int8"), ("int8_kv_calibrated", "int8")):
            t0 = time.monotonic()
            model = ppl.load_for_eval(tmp, kv_cache_dtype=kv, device=DEVICE)  # the sidecar: calibrated scales
            if name == "int8_kv_default_scale":
                model.kv_scales.fill_(model.args.kv_scale)
            scores[name] = dict(ppl.perplexity(model, ids, window=PPL_WINDOW), seconds=time.monotonic() - t0)
            nlls[name] = token_nlls(torch, model, ids)
            del model
            gc.collect()
            torch.cuda.empty_cache()
        deviation = {name: (nlls[name] - nlls["bf16_kv"]).abs().mean().item()
                     for name in ("int8_kv_default_scale", "int8_kv_calibrated")}
        ratio = scores["int8_kv_calibrated"]["ppl"] / scores["int8_kv_default_scale"]["ppl"]
        emit(dict(phase="tinyllama_ppl", window=PPL_WINDOW, **scores, mean_abs_token_nll_deviation=deviation,
                  calibrated_over_default_ppl=ratio, reference_slack=PPL_CALIBRATED_SLACK,
                  card=card["nvidia_smi"]))
        if not deviation["int8_kv_calibrated"] <= deviation["int8_kv_default_scale"]:
            fail(f"calibrated int8 KV scales move each token's NLL further from bf16 KV's than the default scale: "
                 f"{deviation}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    cfg = GPT2
    path, nbytes, _ = write_temp_checkpoint(torch, "gpt2", cfg, gpt2_checkpoint_tensors(cfg), None, scaled_init(cfg))
    try:
        launches["gpt2"] = phase_end_to_end_moe(torch, card, "gpt2", path, layers_of(cfg), layers_of(cfg), nbytes, "",
                                                MOE_SERVES, kv_cache_dtype="int8")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return launches


def serve_swap(torch, card, tag, path, **kw):
    """Phase 18's traffic (phase 4's 8 prompts, 32 greedy tokens each)
    through a fresh engine with graphs, async (the default): each request's
    prompt and generated ids, the swap and preemption counters' moves, and
    the wall time; the engine stays open (the caller closes it)."""
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    names = ("num_preempted_requests", "num_swap_out", "num_swap_in", "num_swap_evictions", "kv_swap_out_bytes",
             "kv_swap_in_bytes")
    llm = serving_llm(path, True, "async", **kw)
    ids = record_outputs(llm)
    before = {c: COUNTERS.get(c) for c in names}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = llm.generate(prompts(), SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    moved = {c: COUNTERS.get(c) - v for c, v in before.items()}
    if len(outs) != 8 or any(len(gen) != 32 for _, gen in ids.values()):
        fail(f"{tag}: a request did not finish with 32 tokens")
    emit(dict(phase=f"{tag}_e2e", kv_blocks=llm._handler.engine.block_manager.options.num_blocks, **kw,
              wall_s=wall, output_tok_per_s=256 / wall, **moved, card=card["nvidia_smi"]))
    return llm, ids, moved


def phase_kv_swap(torch, card):
    """Phase 18: KV swap on phase 4's checkpoint. The same traffic through
    three engines with graphs (async): ample memory (the ground truth);
    num_blocks enough for about three of the eight requests with
    SWAP_POOL_BYTES of host memory for preempted pages; and the same tight
    memory without swap (preempted requests re-prefill). The swap serve
    must swap out and in; each of its requests gets the ample serve's ids,
    or, where one differs, the phase emits the request and step, and every
    differing token must be a greedy choice up to kernel rounding
    (teacher_forced_gap within LOGITS_TOL): a flip from the other batches
    tight memory builds, which the serve without swap shows too, and not
    from restored pages. Then swap_direct_check on the swap engine."""
    import math

    from scalellm_tpu_torch.tokenizer.tokenizer import load_tokenizer

    tmp = tempfile.mkdtemp(prefix="scalellm_tinyllama_swap_")
    llm = None
    try:
        write_checkpoint(torch, tmp, TINYLLAMA)
        tok = load_tokenizer(tmp, None)
        need = [math.ceil((len(tok.encode(p)) + 32) / 16) for p in prompts()]
        tight = 1 + math.ceil(3 * sum(need) / len(need))  # three requests' blocks; page 0 is the padding page
        llm, ample, _ = serve_swap(torch, card, "swap_ample", tmp)
        close_llm(torch, card, "swap_ample", llm)
        llm, swapped, moved = serve_swap(torch, card, "swap_tight", tmp, num_blocks=tight,
                                         host_swap_bytes=SWAP_POOL_BYTES)
        if not (moved["num_swap_out"] > 0 and moved["num_swap_in"] > 0):
            fail(f"swap_tight: no swap-out or swap-in under {tight} blocks: {moved}")
        engine = llm._handler.engine
        flips, gaps = [], []
        for prompt, (prompt_ids, gen) in swapped.items():
            want = ample[prompt][1]
            if gen != want:
                step = next(i for i, (a, b) in enumerate(zip(gen, want)) if a != b)
                flips.append(dict(request=prompts().index(prompt), step=step))
                gaps.append(teacher_forced_gap(torch, engine.model, prompt_ids, gen))
        swap_direct_check(torch, card, "swap_tight", engine)
        engine = None
        close_llm(torch, card, "swap_tight", llm)
        llm, recomputed, _ = serve_swap(torch, card, "swap_tight_no_swap", tmp, num_blocks=tight)
        close_llm(torch, card, "swap_tight_no_swap", llm)
        llm = None
        no_swap_flips = [prompts().index(p) for p, (_, gen) in recomputed.items() if gen != ample[p][1]]
        same_as_no_swap = [prompts().index(p) for p, (_, gen) in swapped.items() if gen == recomputed[p][1]]
        emit(dict(phase="swap_ids", tight_blocks=tight, requests_differing=len(flips), flips=flips,
                  largest_gap=max(gaps, default=0.0), tol=LOGITS_TOL, no_swap_requests_differing=no_swap_flips,
                  swap_equal_to_no_swap=same_as_no_swap, card=card["nvidia_smi"]))
        if any(not g <= LOGITS_TOL for g in gaps):
            fail(f"swap_tight: a request's tokens differ from the ample serve's by more than kernel rounding "
                 f"(largest gap {max(gaps)} > {LOGITS_TOL}): {flips}")
    finally:
        if llm is not None:
            llm.close()
        shutil.rmtree(tmp, ignore_errors=True)



# ------------------------------------------------------------------ phase 19

# meta-llama/Llama-2-7b-hf config.json: phase 19's target.
LLAMA2_7B = dict(
    model_type="llama", architectures=["LlamaForCausalLM"], torch_dtype="bfloat16",
    hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, vocab_size=32000,
    max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=10000.0,
    hidden_act="silu", tie_word_embeddings=False, bos_token_id=1, eos_token_id=2,
)
SPEC_K = 4  # tokens a round proposes
SPEC_ACCEPTANCE_MIN = 0.9  # (b): greedy self-drafting, where only rounding may reject
SPEC_TOP = 5  # (e): prompt logprobs' top-k
SPEC_CHUNK = 64  # (e): the chunked serve's token budget


def repeat_prompts(seed=SEED):
    """8 prompts that repeat text (a phrase of 20-60 chars 4-10 times, up to
    600 chars): prompt lookup's traffic."""
    import random

    rng = random.Random(seed)
    words = ["attention", "kernel", "paged", "cache", "token", "batch", "decode", "prefill", "the", "a", "model"]
    out = []
    for n, times in ((20, 4), (30, 6), (40, 8), (60, 10), (24, 5), (36, 7), (50, 9), (28, 10)):
        phrase = ""
        while len(phrase) < n:
            phrase += rng.choice(words) + " "
        out.append((phrase[:n] * times)[:600])
    return out


def spec_serve(torch, card, name, llm, ps, sp, warm=None):
    """One timed generate of prompts `ps` under SamplingParams `sp` through
    `llm` (after one of `warm`, prompts of the same lengths, on the same
    engine, which captures every graph the timed traffic takes), with every
    engine dispatch's and round's K1 launches held to the model: a plain
    step of the target or the draft once a layer (watch_steps: each replay
    as its capture counted), a draft round k times a draft layer and once a
    target layer, an n-gram round once a target layer. Fails on a capture
    inside the timed generate or a request that did not finish with its
    max_tokens. Returns the ids by prompt, the rounds' accepted rows, the K1
    launches, the wall time and the figures of the `{name}_e2e` line."""
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.speculative.spec_executor import round_plan
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    k1 = attention.ragged_paged_attention_cuda
    engine = llm._handler.engine
    spec = getattr(engine, "spec_executor", None)
    target = getattr(engine, "target", engine)
    draft = getattr(engine, "draft", None)
    if warm is not None:
        llm.generate(warm, sp)
    watched = [(target, layers_of_model(target))] + ([(draft, layers_of_model(draft))] if draft else [])
    logs = [watch_steps(e, (k1,))[0] for e, _ in watched]
    rounds = []
    if spec is not None:
        real = spec.run
        per_round = layers_of_model(target) + (SPEC_K * layers_of_model(draft) if draft else 0)

        def run(arrays, S, MAXP):
            graphs = spec.target.graphs
            key = spec.key(S, MAXP, round_plan(arrays))
            known = graphs is not None and key in graphs.graphs
            before = k1.launches
            out = real(arrays, S, MAXP)
            got = k1.launches - before
            if known:
                got += getattr(graphs.graphs[key], "launches", {}).get(k1.__name__, 0)
            n = int(arrays["num_seqs"][0])
            rounds.append(dict(rows=out[:n, : SPEC_K + 1], k1=got, captured=graphs is not None and not known))
            if got != per_round * (2 if rounds[-1]["captured"] and graphs.cuda else 1):
                fail(f"{name}: a round (S={S}, MAXP={MAXP}) launched K1 {got} times, expected {per_round} a run")
            return out

        spec.run = run
    ids = record_outputs(llm)
    names = ("num_mid_serve_compiles", "num_accepted_tokens_total", "num_draft_tokens_total")
    before = {c: COUNTERS.get(c) for c in names}
    k1.launches = 0
    for log in logs:
        del log[:]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = llm.generate(ps, sp)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    moved = {c: COUNTERS.get(c) - v for c, v in before.items()}
    if spec is not None:
        spec.__dict__.pop("run", None)
    for e, _ in watched:
        unwatch_steps(e)
    launches = sum(r["k1"] for r in rounds)
    for (e, layers), log in zip(watched, logs):
        for T, S, decode_only, runs, got in log:
            if got != runs * layers:
                fail(f"{name}: a plain step (T={T}, S={S}) launched K1 {got} times, expected {runs * layers}")
            launches += got
    n_tokens = sum(o.usage.num_generated_tokens for o in outs)
    if len(outs) != len(ps) or any(not (o.finished and o.status.ok and o.usage.num_generated_tokens
                                        == sp.max_tokens) for o in outs):
        fail(f"{name}: a request did not finish with {sp.max_tokens} tokens")
    if engine.options.enable_cuda_graph and warm is not None and moved["num_mid_serve_compiles"]:
        fail(f"{name}: {moved['num_mid_serve_compiles']} graphs were captured inside the timed generate")
    kept = [int((r >= 0).sum()) - 1 for rd in rounds for r in rd["rows"]]
    figures = dict(output_tok_per_s=n_tokens / wall, wall_s=wall, rounds=len(rounds),
                   round_rows=len(kept), acceptance=sum(kept) / (SPEC_K * len(kept)) if kept else None,
                   plain_steps=sum(len(log) for log in logs), k1_launches=launches,
                   k1_per_round=rounds[0]["k1"] if rounds else None, **moved,
                   kv_blocks=engine.block_manager.options.num_blocks)
    emit(dict(phase=f"{name}_e2e", requests=len(outs), output_tokens=n_tokens, **figures, card=card["nvidia_smi"]))
    return dict(ids=ids, outs=outs, launches=launches, figures=figures)


def copy_prone(torch, model):
    """Set `model`'s lm_head to its embedding table, in place (the captured
    graphs read the same tensor): the random model's logits then favour the
    token it was fed, so that it repeats its last token and prompt lookup's
    proposals come true, where the random target's own greedy outputs
    repeat no n-gram in 32 tokens on the card (PERF.md §6). Returns the
    lm_head as it was."""
    with torch.no_grad():
        saved = model.lm_head.clone()
        model.lm_head.copy_(model.embed_tokens)
    return saved


def layers_of_model(engine):
    return engine.model_args.n_layers


def check_lossless(torch, name, model, plain, run):
    """Each request of `run` gets the plain serve's ids, or every differing
    token is a greedy choice up to kernel rounding (teacher_forced_gap
    through the plain serve's model, the target). Returns the figures."""
    differing, gaps = [], []
    for prompt, (prompt_ids, gen) in run["ids"].items():
        if gen != plain["ids"][prompt][1]:
            differing.append(prompt)
            gaps.append(teacher_forced_gap(torch, model, prompt_ids, gen))
    out = dict(requests_differing=len(differing), largest_gap=max(gaps, default=0.0), tol=LOGITS_TOL)
    if any(not g <= LOGITS_TOL for g in gaps):
        fail(f"{name}: a request's tokens differ from the plain serve's by more than kernel rounding "
             f"(largest gap {max(gaps)} > {LOGITS_TOL})")
    return out


def round_device_split(torch, card, name, engine):
    """The device time of one round of the widest draft-round graph the
    serve captured: its replay (CUDA events, on the inputs of the last round
    of that key, which it rewrites with the same values), and the same round
    run eagerly under torch.profiler, its kernels' device time split by the
    three ranges that launched them (draft, verify, sampler;
    spec_executor.RANGES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scalellm_tpu_torch.speculative.spec_executor import RANGES, round_views

    spec = engine.spec_executor
    graphs = spec.target.graphs
    keys = [k for k in graphs.graphs if k[0] == spec.kind]
    kind, S, MAXP, k, plan = max(keys, key=lambda key: key[1])
    step = graphs.graphs[(kind, S, MAXP, k, plan)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graphs._replay(step)
    start.record()
    for _ in range(TIMED_RUNS):
        graphs._replay(step)
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / TIMED_RUNS
    views = round_views(step.inputs, S, MAXP, k)
    runs = 3
    with torch.inference_mode():
        spec._round(views, plan, S)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                spec._round(views, plan, S)
            torch.cuda.synchronize()
    # Each kernel goes to the range whose host span holds the host event
    # that launched it (the kernel's linked correlation id).
    events = list(prof.profiler.kineto_results.events())
    host = {e.correlation_id(): e.start_ns() for e in events if e.device_type() == DeviceType.CPU}
    spans = [(e.start_ns(), e.end_ns(), e.name()) for e in events
             if e.device_type() == DeviceType.CPU and e.name() in RANGES]
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA and e.name() not in RANGES]
    split = {stage: 0.0 for stage in RANGES}
    for e in kernels:
        t = host.get(e.linked_correlation_id())
        stage = next((n for a, b, n in spans if t is not None and a <= t <= b), None)
        if stage is not None:
            split[stage] += e.duration_ns() / 1e6 / runs
    busy = union_ms([(e.start_ns() / 1e3, e.end_ns() / 1e3) for e in kernels]) / runs
    line = dict(phase=f"{name}_round_device", S=S, MAXP=MAXP, k=k, replay_ms=replay_ms, eager_device_busy_ms=busy,
                **{n.split(".")[-1] + "_ms": ms for n, ms in split.items()},
                unattributed_ms=sum(e.duration_ns() for e in kernels) / 1e6 / runs - sum(split.values()),
                card=card["nvidia_smi"])
    emit(line)
    if not all(ms > 0 for ms in split.values()):
        fail(f"{name}: the profiler gave no device time to a stage of the round: {split}")
    return line


def prompt_scores(llm, ps):
    """prompt_logprobs (top SPEC_TOP) of each prompt: [(position, token id,
    logprob, top ids, top logprobs)]."""
    from scalellm_tpu_torch import SamplingParams

    outs = llm.generate(ps, SamplingParams(max_tokens=1, temperature=0.0, ignore_eos=True,
                                           prompt_logprobs=SPEC_TOP))
    got = []
    for o in outs:
        if not (o.finished and o.status.ok and o.prompt_logprobs is not None):
            fail(f"prompt logprobs: a request did not finish: {o.status}")
        got.append([(i, lp.token_id, lp.logprob, [d.token_id for d in lp.top_logprobs],
                     [d.logprob for d in lp.top_logprobs]) for i, lp in enumerate(o.prompt_logprobs) if i > 0])
    return got


def check_prompt_scores(torch, card, model, tok, ps, got):
    """(e): each position's logprob within LOGITS_TOL of a teacher-forced
    prefill of the prompt through `model` with the plain attention (f32
    log_softmax of its logits), and the top ids equal at every rank whose
    logprob stands more than LOGITS_TOL from both neighbours'."""
    from scalellm_tpu_torch.ops import attention

    err, checked_ranks, positions = 0.0, 0, 0
    model.attn_impl = attention.plain_ragged_paged_attention
    try:
        for prompt, scores in zip(ps, got):
            ids = tok.encode(prompt)
            mi, n_pages = batch_inputs(torch, [(ids, 0, len(ids) + 1)])
            with torch.inference_mode():
                kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.kv_cache_dtype(), device=DEVICE)
                lp = torch.log_softmax(model.logits(model(kv, mi.to(DEVICE), all_hidden=True)[: len(ids)]).float(), -1)
                del kv
            if len(scores) != len(ids) - 1:
                fail(f"prompt logprobs: {len(scores)} scored positions for a prompt of {len(ids)} tokens")
            ref_top, ref_ids = torch.topk(lp, SPEC_TOP + 1, dim=-1)
            ref_top, ref_ids = ref_top.cpu(), ref_ids.cpu()
            for i, tid, value, top_ids, _ in scores:
                if tid != ids[i]:
                    fail(f"prompt logprobs: position {i} scored token {tid}, the prompt has {ids[i]}")
                err = max(err, abs(value - lp[i - 1, tid].item()))
                v = ref_top[i - 1]
                for j in range(SPEC_TOP):
                    if (j == 0 or v[j - 1] - v[j] > LOGITS_TOL) and v[j] - v[j + 1] > LOGITS_TOL:
                        checked_ranks += 1
                        if top_ids[j] != ref_ids[i - 1, j].item():
                            fail(f"prompt logprobs: position {i} rank {j}: id {top_ids[j]}, the plain forward's "
                                 f"{ref_ids[i - 1, j].item()}")
                positions += 1
    finally:
        model.attn_impl = attention.ragged_paged_attention
    return dict(positions=positions, max_abs_err=err, top_ranks_checked=checked_ranks, tol=LOGITS_TOL)


def phase_speculative(torch, card, tinyllama_path=None):
    """Phase 19 (see the module docstring). Returns K1's launches on its
    main paths: the timed serves of the draft-model and n-gram rounds with
    graphs."""
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.tokenizer.tokenizer import load_tokenizer

    cfg = LLAMA2_7B
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    spec = dict(num_speculative_tokens=SPEC_K)
    tiny = tempfile.mkdtemp(prefix="scalellm_tinyllama_draft_")
    path = None
    llm = None
    launches = 0
    try:
        t0 = time.monotonic()
        write_checkpoint(torch, tiny, TINYLLAMA)
        path, nbytes, t_write = write_temp_checkpoint(torch, "llama2_7b", cfg, checkpoint_tensors(cfg), None,
                                                      scaled_init(cfg))
        emit(dict(phase="spec_checkpoints", target_bytes=nbytes, write_s=time.monotonic() - t0,
                  target_layers=cfg["num_hidden_layers"], draft_layers=TINYLLAMA["num_hidden_layers"]))
        tok = load_tokenizer(path, None)

        # The plain target serve: the ground truth of (a), (c) and (e).
        llm = serving_llm(path, True, "async")
        plain = spec_serve(torch, card, "spec_plain", llm, prompts(), greedy, warm=prompts(SEED + 1))
        # (e) on prompts of the same lengths that the engine has not seen
        # (a scoring request skips the prefix cache in any case).
        scored = prompts(SEED + 2)
        model = llm._handler.engine.model
        whole = prompt_scores(llm, scored)
        # (c)'s ground truth: the copy-prone target on prompts that repeat.
        saved = copy_prone(torch, model)
        plain_rep = spec_serve(torch, card, "spec_plain_repeat", llm, repeat_prompts(), greedy,
                               warm=repeat_prompts(SEED + 1))
        with torch.no_grad():
            model.lm_head.copy_(saved)
        saved = None
        # The engine's KV cache is freed first, to leave room for the plain
        # attention's gathered copies of K and V.
        close_llm(torch, card, "spec_plain", llm)
        llm = None
        scores = check_prompt_scores(torch, card, model, tok, scored, whole)
        model = None
        torch.cuda.empty_cache()
        llm = serving_llm(path, False, "sync", max_tokens_per_batch=SPEC_CHUNK)
        chunked = prompt_scores(llm, scored)
        close_llm(torch, card, "spec_plain_chunked", llm)
        llm = None
        chunk_err = max(abs(a[2] - b[2]) for p, q in zip(whole, chunked) for a, b in zip(p, q))
        emit(dict(phase="spec_prompt_logprobs", top=SPEC_TOP, **scores, chunked_tokens_per_batch=SPEC_CHUNK,
                  chunked_max_abs_diff=chunk_err, card=card["nvidia_smi"]))
        if not (scores["max_abs_err"] <= LOGITS_TOL and chunk_err <= LOGITS_TOL):
            fail(f"prompt logprobs differ by {scores['max_abs_err']} from the plain forward, by {chunk_err} "
                 f"chunked from whole (> {LOGITS_TOL})")

        # (a) the draft model's rounds with graphs, then eagerly.
        runs = {}
        for graphs in (True, False):
            name = "spec_draft" if graphs else "spec_draft_eager"
            t0 = time.monotonic()
            llm = serving_llm(path, graphs, "async", draft_model_path=tiny, **spec)
            emit(dict(phase=f"{name}_setup", load_s=time.monotonic() - t0, **graph_stats(llm._handler.engine.target),
                      draft_graphs=graph_stats(llm._handler.engine.draft)))
            runs[graphs] = spec_serve(torch, card, name, llm, prompts(), greedy, warm=prompts(SEED + 1))
            if graphs:
                launches += runs[graphs]["launches"]
                split = round_device_split(torch, card, name, llm._handler.engine)
            engine = llm._handler.engine
            lossless = check_lossless(torch, name, engine.target.model, plain, runs[graphs])
            engine = None
            close_llm(torch, card, name, llm)
            llm = None
            emit(dict(phase=f"{name}_lossless", **lossless, card=card["nvidia_smi"]))
        same = {p: ids[1] for p, ids in runs[True]["ids"].items()} == {p: ids[1] for p, ids in runs[False]["ids"].items()}
        emit(dict(phase="spec_draft_graphs_vs_eager", same_ids=same, plain=plain["figures"],
                  graphs=runs[True]["figures"], eager=runs[False]["figures"], round_device=split,
                  card=card["nvidia_smi"]))
        if not same:
            fail("spec_draft: the serve with graphs gave other ids than the eager serve")

        # (c) prompt lookup on text that repeats, through the copy-prone target.
        llm = serving_llm(path, True, "async", **spec)
        copy_prone(torch, llm._handler.engine.target.model)
        ngram = spec_serve(torch, card, "spec_ngram", llm, repeat_prompts(), greedy, warm=repeat_prompts(SEED + 1))
        launches += ngram["launches"]
        lossless = check_lossless(torch, "spec_ngram", llm._handler.engine.target.model, plain_rep, ngram)
        close_llm(torch, card, "spec_ngram", llm)
        llm = None
        emit(dict(phase="spec_ngram_lossless", **lossless, plain=plain_rep["figures"], card=card["nvidia_smi"]))
        if not ngram["figures"]["num_accepted_tokens_total"] > 0:
            fail("spec_ngram: no proposal was ever verified (num_accepted_tokens_total 0)")
        shutil.rmtree(path, ignore_errors=True)
        path = None

        # (b) TinyLlama as its own draft; (d) sampled speculation, twice.
        llm = serving_llm(tiny, True, "async", draft_model_path=tiny, **spec)
        self_draft = spec_serve(torch, card, "spec_self_draft", llm, prompts(), greedy, warm=prompts(SEED + 1))
        close_llm(torch, card, "spec_self_draft", llm)
        llm = None
        acceptance = self_draft["figures"]["acceptance"]
        if not (acceptance is not None and acceptance >= SPEC_ACCEPTANCE_MIN):
            fail(f"spec_self_draft: acceptance {acceptance} < {SPEC_ACCEPTANCE_MIN}")
        sampled = [SamplingParams(max_tokens=32, temperature=1.0, top_p=0.9, seed=100 + i, ignore_eos=True)
                   for i in range(len(prompts()))]
        sampled_ids = []
        for i in range(2):
            llm = serving_llm(tiny, True, "async", draft_model_path=tiny, **spec)
            ids = record_outputs(llm)
            outs = llm.generate(prompts(), sampled)
            close_llm(torch, card, f"spec_sampled_{i}", llm)
            llm = None
            if any(not (o.finished and o.usage.num_generated_tokens == 32) for o in outs):
                fail("spec_sampled: a request did not finish with 32 tokens")
            sampled_ids.append({p: gen for p, (_, gen) in ids.items()})
        emit(dict(phase="spec_sampled", same_ids=sampled_ids[0] == sampled_ids[1],
                  distinct_outputs=len({tuple(g) for g in sampled_ids[0].values()}), card=card["nvidia_smi"]))
        if sampled_ids[0] != sampled_ids[1]:
            fail("spec_sampled: two serves with the same seeds gave other ids")
        return launches
    finally:
        if llm is not None:
            llm.close()
        shutil.rmtree(tiny, ignore_errors=True)
        if path is not None:
            shutil.rmtree(path, ignore_errors=True)

# ------------------------------------------------------------------ phase 20

# Phase 20's adapters (HF PEFT layout, random, write_lora_adapter): "one" on
# all seven targets, "two" on q_proj and v_proj; A and B drawn N(0,
# LORA_STD), as the base weights of phases 4 and 5.
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
LORA_ADAPTERS = {"one": dict(r=16, alpha=32, targets=LORA_TARGETS, seed=101),
                 "two": dict(r=8, alpha=8, targets=("q_proj", "v_proj"), seed=102)}
LORA_STD = 0.02
# The adapter of each of the 8 requests of prompts(): base, "one" and "two".
LORA_OF_REQUEST = [None, "one", "two", None, "one", "two", "one", None]
# "one" against the base on the same tokens, through the same kernels: the
# delta was applied.
LORA_MOVE_MIN = 1e-3


def lora_dims(cfg):
    """target -> (K, N) of a Llama config's projections."""
    D, F_ = cfg["hidden_size"], cfg["intermediate_size"]
    Dh = D // cfg["num_attention_heads"]
    q, kv = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    return {"q_proj": (D, q), "k_proj": (D, kv), "v_proj": (D, kv), "o_proj": (q, D),
            "gate_proj": (D, F_), "up_proj": (D, F_), "down_proj": (F_, D)}


def lora_group(target):
    return "self_attn" if target in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"


def write_safetensors(torch, path, tensors):
    """A .safetensors file of {name: CPU tensor} (f32 or bf16). Returns the
    bytes of tensor data."""
    kinds = {torch.float32: "F32", torch.bfloat16: "BF16"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": kinds[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            f.write(memoryview(t.contiguous().view(torch.uint8).numpy().reshape(-1)))
    return offset


def write_lora_adapters(torch, root, cfg):
    """LORA_ADAPTERS at cfg's widths, each in the HF PEFT layout under root
    (adapter_config.json, adapter_model.safetensors: A [r, K] and B [N, r]
    f32 for every layer and target, from a seeded generator). Returns
    ({name: directory}, {name: {(layer, target): (A, B)}}, bytes of tensor
    data)."""
    dims, dirs, mats, nbytes = lora_dims(cfg), {}, {}, 0
    for name, spec in LORA_ADAPTERS.items():
        path = os.path.join(root, f"adapter_{name}")
        os.makedirs(path, exist_ok=True)
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(spec["seed"])
        tensors, mats[name] = {}, {}
        for layer in range(layers_of(cfg)):
            for t in spec["targets"]:
                K, N = dims[t]
                A = (torch.randn(spec["r"], K, generator=gen, device=DEVICE) * LORA_STD).cpu()
                B = (torch.randn(N, spec["r"], generator=gen, device=DEVICE) * LORA_STD).cpu()
                prefix = f"base_model.model.model.layers.{layer}.{lora_group(t)}.{t}"
                tensors[f"{prefix}.lora_A.weight"], tensors[f"{prefix}.lora_B.weight"] = A, B
                mats[name][(layer, t)] = (A, B)
        nbytes += write_safetensors(torch, os.path.join(path, "adapter_model.safetensors"), tensors)
        with open(os.path.join(path, "adapter_config.json"), "w") as f:
            json.dump({"peft_type": "LORA", "r": spec["r"], "lora_alpha": spec["alpha"],
                       "target_modules": list(spec["targets"])}, f)
        dirs[name] = path
    return dirs, mats, nbytes


def write_merged_checkpoint(torch, path, base, mats, scaling):
    """The bf16 Llama checkpoint `base` with an adapter folded into its
    weights offline: W + (B A) scaling in f32 on the card, rounded to bf16."""
    from scalellm_tpu_torch.model_loader.loader import read_safetensors

    os.makedirs(path, exist_ok=True)
    for name in ("config.json", "tokenizer.json"):
        shutil.copy(os.path.join(base, name), os.path.join(path, name))
    tensors = dict(read_safetensors(os.path.join(base, "model.safetensors")))
    for (layer, t), (A, B) in mats.items():
        key = f"model.layers.{layer}.{lora_group(t)}.{t}.weight"
        w = tensors[key].to(DEVICE).float()
        tensors[key] = (w + (B.to(DEVICE) @ A.to(DEVICE)) * scaling).to(torch.bfloat16).cpu()
    write_safetensors(torch, os.path.join(path, "model.safetensors"), tensors)


def lora_kernel_check(torch, card, tag, model, ids, slots, quant):
    """A prefill batch of three sequences under the adapter `slots`, and the
    decode step after it, through the model's kernels, then through the
    plain versions (K1's; with quant, also the quantized matmuls'): each
    within LOGITS_TOL (`{tag}_logits` lines). Then the kernels again with
    every sequence on the base: returns the largest change of the slot-1
    sequence's logits (the delta applied)."""
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops import quant_matmul as Q
    from scalellm_tpu_torch.ops.attention import plain_ragged_paged_attention

    n_tok = sum(len(t) for t in ids)
    logits = {}
    with torch.inference_mode():
        for impl in ("kernel", "plain", "base"):
            plain = impl == "plain"
            lora = [0] * len(ids) if impl == "base" else slots
            prefill, n_pages = batch_inputs(torch, [(t, 0, len(t) + 1) for t in ids], lora=lora)
            decode, _ = batch_inputs(torch, [([7 + i], len(t), len(t) + 1) for i, t in enumerate(ids)], lora=lora)
            model.attn_impl = plain_ragged_paged_attention if plain else attention.ragged_paged_attention
            if quant:
                model.quant_impl = Q.plain_quant_matmul if plain else Q.quant_matmul
            kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=DEVICE)
            a = model.logits(model(kv, prefill.to(DEVICE), all_hidden=True)[:n_tok])
            b = model.logits(model(kv, decode.to(DEVICE), decode_only=True)[: len(ids)])
            logits[impl] = (a, b)
            del kv
    model.attn_impl = attention.ragged_paged_attention
    if quant:
        model.quant_impl = Q.quant_matmul
    for which, i in (("prefill", 0), ("decode", 1)):
        got, want = logits["kernel"][i], logits["plain"][i]
        diff = (got - want).abs()
        err = diff.max().item()
        emit(dict(phase=f"{tag}_logits", batch=which, rows=got.shape[0], slots=slots, max_abs_err=err,
                  mean_abs_err=diff.mean().item(), logits_std=want.std().item(),
                  argmax_agreement=(got.argmax(-1) == want.argmax(-1)).float().mean().item(), tol=LOGITS_TOL))
        if not torch.isfinite(got).all() or not err <= LOGITS_TOL:
            fail(f"{tag} {which}: kernel logits differ from plain logits by {err} > {LOGITS_TOL}")
    j = slots.index(1)
    first = sum(len(t) for t in ids[:j])
    rows = slice(first, first + len(ids[j]))
    return max((logits["kernel"][0][rows] - logits["base"][0][rows]).abs().max().item(),
               (logits["kernel"][1][j] - logits["base"][1][j]).abs().max().item())


def lora_figures(run):
    f = run["figures"]
    return {k: f[k] for k in ("output_tok_per_s", "mean_ttft_s", "decode_step_ms", "idle_share", "engine_steps")}


def phase_lora(torch, card, int4_layers):
    """Phase 20 (see the module docstring). Returns the launches of its main
    paths by wrapper name: the LoRA serves with graphs."""
    import scalellm_tpu_torch.models.common as common
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops import quant_matmul as Q

    root = tempfile.mkdtemp(prefix="scalellm_lora_")
    llm = None
    engine = model = None
    greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
    k1 = attention.ragged_paged_attention_cuda
    slot_of = {name: i + 1 for i, name in enumerate(LORA_ADAPTERS)}
    ps = prompts()
    slots = {p: slot_of.get(n, 0) for p, n in zip(ps, LORA_OF_REQUEST)}
    slots.update({p: slot_of.get(n, 0) for p, n in zip(prompts(SEED + 1), LORA_OF_REQUEST)})
    try:
        # bf16 TinyLlama-1.1B at full width and depth.
        t0 = time.monotonic()
        tiny = os.path.join(root, "tinyllama")
        os.makedirs(tiny)
        write_checkpoint(torch, tiny, TINYLLAMA)
        adapters, mats, adapter_bytes = write_lora_adapters(torch, root, TINYLLAMA)
        one = LORA_ADAPTERS["one"]
        merged = os.path.join(root, "tinyllama_merged_one")
        write_merged_checkpoint(torch, merged, tiny, mats["one"], one["alpha"] / one["r"])
        mats = None
        emit(dict(phase="lora_checkpoints", model="tinyllama", write_s=time.monotonic() - t0,
                  adapter_bytes=adapter_bytes, adapters={n: {k: v for k, v in a.items() if k != "seed"}
                                                         for n, a in LORA_ADAPTERS.items()}))
        L = TINYLLAMA["num_hidden_layers"]
        runs, modes = {}, {}
        # The base model (async, graphs: what LoRA costs), then with both
        # adapters: sync with graphs, async (the default), 4-step decode,
        # and eager; each on a fresh engine. K1 exactly once a layer a step.
        for mode in ("base", "sync", "async", "ms4", "eager"):
            graphs = mode != "eager"
            step = {"base": "async", "eager": "sync"}.get(mode, mode)
            extra = {} if mode == "base" else dict(lora_modules=adapters)
            tag = "lora_base" if mode == "base" else "lora"
            t0 = time.monotonic()
            llm = serving_llm(tiny, graphs, step, **extra)
            torch.cuda.synchronize()
            engine = llm._handler.engine
            emit(dict(phase=serve_setup(tag, step if graphs else "eager"), graphs=graphs,
                      load_s=time.monotonic() - t0, kv_blocks=engine.block_manager.options.num_blocks,
                      lora_adapters=list(adapters) if extra else [], **graph_stats(engine)))
            runs[mode] = serve(torch, card, tag, llm, (k1,), lambda T, S, decode_only: {k1.__name__: L}, graphs,
                               step, lora=None if mode == "base" else LORA_OF_REQUEST)
            if mode in ("async", "ms4"):
                modes[mode] = check_mode(torch, "lora", mode, engine.model, runs["sync"], runs[mode], slots=slots)
            if graphs:
                engine = None
                close_llm(torch, card, serve_name(tag, step), llm)
                llm = None
        compare_serves(card, "lora", runs["sync"], runs["eager"])
        emit_modes(card, "lora", runs, modes)
        launches = main_path_launches(runs)

        # The checkpoint merged offline with "one": each "one" request gets
        # the runtime serve's ids, or differs by tokens that are greedy
        # choices of the LoRA model up to kernel rounding.
        model, tok = engine.model, llm._handler.tokenizer
        engine = None
        close_llm(torch, card, "lora_eager", llm)
        llm = serving_llm(merged, True, "sync")
        ids = record_outputs(llm)
        outs = llm.generate(ps, greedy)
        close_llm(torch, card, "lora_merged", llm)
        llm = None
        if not all(o.finished and o.usage.num_generated_tokens == 32 for o in outs):
            fail("lora_merged: a request did not finish with 32 tokens")
        gaps = {}
        for p, name in zip(ps, LORA_OF_REQUEST):
            if name == "one" and ids[p][1] != runs["sync"]["ids"][p][1]:
                gaps[p] = teacher_forced_gap(torch, model, ids[p][0], ids[p][1], lora=slot_of["one"])
        emit(dict(phase="lora_merged", requests=LORA_OF_REQUEST.count("one"), requests_differing=len(gaps),
                  largest_gap=max(gaps.values(), default=0.0), tol=LOGITS_TOL, card=card["nvidia_smi"]))
        if any(not g <= LOGITS_TOL for g in gaps.values()):
            fail(f"lora_merged: a 'one' request of the merged checkpoint differs from the runtime adapter's by more "
                 f"than kernel rounding (largest gap {max(gaps.values())} > {LOGITS_TOL})")
        seqs = [tok.encode(ps[0])[:200], tok.encode(ps[5]), tok.encode(ps[3])]
        moved = lora_kernel_check(torch, card, "lora", model, seqs, [0, 1, 2], quant=False)
        emit(dict(phase="lora_delta", model="tinyllama", one_vs_base_max_abs=moved, min=LORA_MOVE_MIN))
        if not moved > LORA_MOVE_MIN:
            fail(f"lora: adapter 'one' moved the logits by {moved} only: the delta was not applied")
        model = None
        torch.cuda.empty_cache()
        shutil.rmtree(tiny, ignore_errors=True)
        shutil.rmtree(merged, ignore_errors=True)

        # INT4 Llama-3.1-8B widths (GPTQ, phase 5's depth) with both adapters:
        # sync with graphs and eagerly, beside the base; no quantized matmul
        # may get the RMSNorm prologue (rms_gamma) with adapters loaded.
        t0 = time.monotonic()
        cfg = dict(LLAMA31_8B_INT4, num_hidden_layers=int4_layers)
        path = os.path.join(root, "llama8b_int4")
        os.makedirs(path)
        write_gptq_checkpoint(torch, path, cfg)
        adapters8, _, adapter_bytes8 = write_lora_adapters(torch, os.path.join(root, "llama8b"), cfg)
        emit(dict(phase="lora_checkpoints", model="llama8b_int4", layers=int4_layers,
                  write_s=time.monotonic() - t0, adapter_bytes=adapter_bytes8))
        w4a8, group, dequant = Q.quant_matmul_w4a8_cuda, Q.quant_matmul_group_cuda, Q.quant_matmul_dequant_cuda
        counters = (k1, w4a8, group, dequant, Q.quant_gemv_cuda, Q.quant_w4a8_gemv_cuda)
        L = int4_layers

        def want(T, S, decode_only):  # phase 5's
            out = {k1.__name__: L, w4a8.__name__: 0, dequant.__name__: 0}
            out[(dequant if T > 64 else w4a8).__name__] += 4 * L
            out[(dequant if S > 64 else w4a8).__name__] += 1
            return out

        prologue = {"base": [0, 0], "lora": [0, 0]}  # [calls with rms_gamma, calls]
        real = common.quant_matmul
        runs8 = {}
        for mode in ("base", "sync", "eager"):
            graphs = mode != "eager"
            who = "base" if mode == "base" else "lora"

            def recorded(*args, who=who, **kw):
                prologue[who][0] += kw.get("rms_gamma") is not None
                prologue[who][1] += 1
                return real(*args, **kw)

            extra = {} if mode == "base" else dict(lora_modules=adapters8)
            tag = "lora_int4_base" if mode == "base" else "lora_int4"
            t0 = time.monotonic()
            common.quant_matmul = recorded  # what every new model binds as its quant_impl
            try:
                llm = serving_llm(path, graphs, "sync", quantize_lm_head=True, **extra)
            finally:
                common.quant_matmul = real
            torch.cuda.synchronize()
            engine = llm._handler.engine
            emit(dict(phase=serve_setup(tag, "sync" if graphs else "eager"), graphs=graphs,
                      load_s=time.monotonic() - t0, kv_blocks=engine.block_manager.options.num_blocks,
                      lora_adapters=list(adapters8) if extra else [], **graph_stats(engine)))
            runs8[mode] = serve(torch, card, tag, llm, counters, want, graphs, "sync",
                                lora=None if mode == "base" else LORA_OF_REQUEST)
            if graphs:
                engine = None
                close_llm(torch, card, serve_name(tag, "sync"), llm)
                llm = None
        compare_serves(card, "lora_int4", runs8["sync"], runs8["eager"])
        for k, v in main_path_launches({"sync": runs8["sync"]}).items():
            launches[k] = launches.get(k, 0) + v
        emit(dict(phase="lora_int4_prologue", lora_rms_calls=prologue["lora"][0], lora_calls=prologue["lora"][1],
                  base_rms_calls=prologue["base"][0], base_calls=prologue["base"][1]))
        if prologue["lora"][0] or not prologue["lora"][1] or not prologue["base"][0]:
            fail(f"lora_int4: {prologue['lora'][0]} of {prologue['lora'][1]} quantized matmuls got the RMSNorm "
                 f"prologue with adapters (the base's: {prologue['base'][0]} of {prologue['base'][1]})")
        model, tok = engine.model, llm._handler.tokenizer
        engine = None
        close_llm(torch, card, "lora_int4_eager", llm)
        llm = None
        model.quant_impl = Q.quant_matmul
        seqs = [tok.encode(ps[0])[:200], tok.encode(ps[5]), tok.encode(ps[3])]
        moved8 = lora_kernel_check(torch, card, "lora_int4", model, seqs, [0, 1, 2], quant=True)
        emit(dict(phase="lora_delta", model="llama8b_int4", one_vs_base_max_abs=moved8, min=LORA_MOVE_MIN))
        if not moved8 > LORA_MOVE_MIN:
            fail(f"lora_int4: adapter 'one' moved the logits by {moved8} only: the delta was not applied")
        model = None
        emit(dict(phase="lora_cost", tinyllama={m: lora_figures(runs[m]) for m in ("base", "sync", "async", "ms4",
                                                                                    "eager")},
                  llama8b_int4={m: lora_figures(runs8[m]) for m in ("base", "sync", "eager")},
                  adapter_bytes={"tinyllama": adapter_bytes, "llama8b_int4": adapter_bytes8},
                  card=card["nvidia_smi"]))
        return launches
    finally:
        engine = model = None
        if llm is not None:
            llm.close()
        shutil.rmtree(root, ignore_errors=True)

# ------------------------------------------------------------------ phase 21

# tests/test_constrained.py:163-171's schema, and tests/test_tools.py's tool
# with a bound on the city's length: a random model's string may otherwise
# run to max_tokens, and the call would never close.
GUIDED_SCHEMA = {"type": "object", "properties": {"name": {"type": "string", "maxLength": 8},
                                                  "count": {"type": "integer"}}, "required": ["name", "count"]}
GUIDED_TOOL = {"type": "function", "function": {
    "name": "get_weather", "description": "Get weather",
    "parameters": {"type": "object", "properties": {"city": {"type": "string", "maxLength": 24},
                                                    "unit": {"type": "string", "enum": ["C", "F"]}},
                   "required": ["city"]}}}
GUIDED_CHOICES = ["yes", "no", "maybe"]
GUIDED_WORDS = ["paged attention", "prefix cache", "decode step"]
GUIDED_PHONE = r"[0-9]{3}-[0-9]{4}"
GUIDED_MAX_TOKENS = 128
# The phase's 8 greedy requests, one a prompt of prompts() (the tool's the
# 16-char one, under the chat template and its tool block): (name, the
# constraint's SamplingParams fields; "tool": the regex of a forced call of
# GUIDED_TOOL, tool_choice "required").
GUIDED_REQUESTS = (("free_0", {}), ("free_1", {}), ("tool", None), ("choice", dict(guided_choice=GUIDED_CHOICES)),
                   ("choice_words", dict(guided_choice=GUIDED_WORDS)), ("regex", dict(guided_regex=GUIDED_PHONE)),
                   ("schema", dict(guided_json=GUIDED_SCHEMA)), ("json_object", dict(guided_json="object")))
GUIDED_AWAIT_S = 120  # every await of the AsyncLLMEngine serve
GUIDED_CANCEL_AFTER = 3  # stream items before the cancelled stream is cancelled


def guided_tokenizer_json(vocab_size):
    """The char tokenizer's tokenizer.json (ids < 256 are their characters,
    and encoding splits text into characters) with a vocabulary of
    `vocab_size` ids: after the 256 char tokens, distinct strings of 2-6
    printable ASCII characters drawn from SEED, none holding "▁" and none
    both starting with "<" and ending with ">". token_vocab_bytes then takes
    its plain UTF-8 branch, a mask row covers every id of the model, and the
    FSM walks multi-character tokens as it would over a BPE vocabulary."""
    import random

    rng = random.Random(SEED)
    spec = char_tokenizer_json()
    vocab = spec["model"]["vocab"]
    while len(vocab) < vocab_size:
        w = "".join(chr(rng.randrange(32, 127)) for _ in range(rng.randint(2, 6)))
        if w not in vocab and not (w.startswith("<") and w.endswith(">")):
            vocab[w] = len(vocab)
    return spec


def tool_prompt(text):
    """A user turn under TinyLlama's chat template (the llama family's coded
    one: the checkpoint has no jinja template) with GUIDED_TOOL's block."""
    from scalellm_tpu_torch import Message
    from scalellm_tpu_torch.utils.chat import apply_chat_template

    return apply_chat_template([Message("user", text)], model_type=TINYLLAMA["model_type"], tools=[GUIDED_TOOL])


def guided_traffic(seed):
    """traffic(seed) of serve(): GUIDED_REQUESTS on prompts(seed), greedy,
    GUIDED_MAX_TOKENS each (ending at the model's end token)."""
    from scalellm_tpu_torch import SamplingParams
    from scalellm_tpu_torch.utils.tools import guided_regex_for_tools

    ps, sps = [], []
    for (name, guide), p in zip(GUIDED_REQUESTS, prompts(seed)):
        if name == "tool":
            p, guide = tool_prompt(p), dict(guided_regex=guided_regex_for_tools([GUIDED_TOOL]))
        ps.append(p)
        sps.append(SamplingParams(max_tokens=GUIDED_MAX_TOKENS, temperature=0.0, **guide))
    return ps, sps


def guided_valid(name, text):
    """Whether an output that ended (STOP) meets request `name`'s
    constraint by the repository's own parsers."""
    import re

    from scalellm_tpu_torch.utils.tools import parse_tool_calls

    if name == "choice":
        return text in GUIDED_CHOICES
    if name == "choice_words":
        return text in GUIDED_WORDS
    if name == "regex":
        return re.fullmatch(GUIDED_PHONE, text) is not None
    try:
        if name == "tool":
            content, calls = parse_tool_calls(text)
            return (content is None and len(calls) == 1 and calls[0].name == "get_weather"
                    and isinstance(json.loads(calls[0].arguments).get("city"), str))
        obj = json.loads(text)
    except ValueError:
        return False
    if name == "schema":
        return isinstance(obj, dict) and isinstance(obj.get("name"), str) and type(obj.get("count")) is int
    return isinstance(obj, dict)


def check_guided_outputs(card, tag, outs):
    """Each guided output in its constraint's language: whole where it
    ended (STOP), and then the choice in its set, the regex a full match,
    the JSON parsed with the schema's types, the tool call parsed with the
    tool's name and JSON arguments; a prefix of a word of it where
    max_tokens cut it, which only an unbounded language (JSON, the schema's
    unbounded integer) may. Emits the `{tag}_outputs` line."""
    from scalellm_tpu_torch.constrained.fsm import DEAD, START, compile_regex
    from scalellm_tpu_torch.constrained.guided import constraint_regex

    rows = {}
    for (name, _), sp, o in zip(GUIDED_REQUESTS, guided_traffic(SEED)[1], outs):
        text, reason = o.outputs[0].text, o.outputs[0].finish_reason.name
        row = rows[name] = dict(text=text[:160], finish=reason, tokens=o.usage.num_generated_tokens)
        if not sp.has_guided:
            continue
        dfa = compile_regex(constraint_regex(sp))
        st = dfa.walk(START, text.encode())
        if reason == "STOP":
            row["valid"] = bool(st != DEAD and dfa.accepting[st]) and guided_valid(name, text)
        else:  # cut at max_tokens: a bounded language ends before it
            row["valid"] = st != DEAD and name in ("schema", "json_object")
    emit(dict(phase=f"{tag}_outputs", requests=rows, card=card["nvidia_smi"]))
    bad = [n for n, r in rows.items() if r.get("valid") is False]
    if bad:
        fail(f"{tag}: outputs outside their constraint: {bad}")


def guided_kernel_check(torch, card, model, masks):
    """At each guided request's first decode step (its prompt prefilled,
    then its first generated token as a decode batch), the greedy choice of
    the kernel path under the request's mask at that step must be the plain
    attention path's greedy choice up to LOGITS_TOL: the plain masked
    logits' largest value less the plain logit of the kernel's choice. masks:
    name -> (prompt ids, generated ids, packed mask row after the first
    token)."""
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops.attention import plain_ragged_paged_attention
    from scalellm_tpu_torch.sampling.sampler import apply_allowed_mask

    import numpy as np

    gaps, agree = {}, 0
    with torch.inference_mode():
        for name, (ids, gen, row) in masks.items():
            prefill, n_pages = batch_inputs(torch, [(ids, 0, len(ids) + 1)])
            decode, _ = batch_inputs(torch, [([gen[0]], len(ids), len(ids) + 1)])
            mask = torch.from_numpy(np.asarray(row, np.uint32).astype(np.int64)[None]).to(DEVICE)
            logits = {}
            for impl in ("kernel", "plain"):
                model.attn_impl = plain_ragged_paged_attention if impl == "plain" else attention.ragged_paged_attention
                kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.kv_cache_dtype(), device=DEVICE)
                model(kv, prefill.to(DEVICE))
                out = model.logits(model(kv, decode.to(DEVICE), decode_only=True)[:1]).float()
                logits[impl] = apply_allowed_mask(out, mask)[0]
                del kv
            model.attn_impl = attention.ragged_paged_attention
            choice = int(logits["kernel"].argmax())
            gaps[name] = (logits["plain"].max() - logits["plain"][choice]).item()
            agree += choice == gen[1]
            if not logits["kernel"][choice] > -1e29:
                fail(f"guided {name}: the kernel path chose a token its mask bans")
    emit(dict(phase="guided_logits", requests=len(masks), largest_gap=max(gaps.values()), gaps=gaps,
              served_choice_agrees=agree, tol=LOGITS_TOL, card=card["nvidia_smi"]))
    if not max(gaps.values()) <= LOGITS_TOL:
        fail(f"guided: the kernel path's masked greedy choice is {max(gaps.values())} below the plain path's "
             f"(> {LOGITS_TOL})")


def time_prepare(log):
    """Make Batch.prepare_model_inputs append (host ms, whether a row is
    guided) to `log` for each call. Returns the unwrapped method."""
    from scalellm_tpu_torch.engine.batch import Batch

    real = Batch.prepare_model_inputs

    def timed(self, *args, **kw):
        t0 = time.perf_counter()
        out = real(self, *args, **kw)
        log.append(((time.perf_counter() - t0) * 1e3, out[1].allowed_mask.shape[1] > 1))
        return out

    Batch.prepare_model_inputs = timed
    return real


async def guided_async_serve(engine, reqs, cancel):
    """reqs: (prompt or chat messages, SamplingParams, tools) streamed at
    once through `engine`; stream `cancel` is cancelled after
    GUIDED_CANCEL_AFTER items. Every await has a deadline. Returns per
    request its concatenated deltas, items, seconds to its first item and
    last output."""
    import asyncio

    async def submit(msg, sp, tools):
        t0 = time.monotonic()
        if tools is None:
            s = await asyncio.wait_for(engine.schedule_async(msg, sp, stream=True), GUIDED_AWAIT_S)
        else:
            s = await asyncio.wait_for(engine.schedule_chat_async(msg, sp, stream=True, tools=tools), GUIDED_AWAIT_S)
        return t0, s

    async def drain(i, t0, s):
        texts, first, last = [], None, None
        it = s.__aiter__()
        while True:
            try:
                out = await asyncio.wait_for(it.__anext__(), GUIDED_AWAIT_S)
            except StopAsyncIteration:
                break
            if first is None:
                first = time.monotonic() - t0
            if out.outputs:
                texts.append(out.outputs[0].text)
            last = out
            if i == cancel and len(texts) == GUIDED_CANCEL_AFTER:
                s.cancel()
        return dict(text="".join(texts), items=len(texts), ttft_s=first, last=last)

    streams = [await submit(*r) for r in reqs]
    return await asyncio.wait_for(asyncio.gather(*(drain(i, t0, s) for i, (t0, s) in enumerate(streams))),
                                  GUIDED_AWAIT_S)


def guided_async_pass(torch, card, tag, engine, inner, done, ps, failed_steps):
    """One AsyncLLMEngine serve of phase 21: GUIDED_REQUESTS on the prompts
    `ps`, streamed at once (the tool's and the schema's as chat requests
    with the tool: a forced call, and a free reply), the first,
    unconstrained, cancelled after GUIDED_CANCEL_AFTER items. Fails unless
    every other stream's deltas make its final text (`done`: request prompt
    -> (cancelled, visible generated ids), noted by the scheduler), the
    cancelled request is retired with its blocks back, no step failed, and
    K1 ran once a layer a step. Returns its K1 launches."""
    import asyncio

    from scalellm_tpu_torch import Message, SamplingParams
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.utils.tools import guided_regex_for_tools

    k1 = attention.ragged_paged_attention_cuda
    L = TINYLLAMA["num_hidden_layers"]
    tool_regex = guided_regex_for_tools([GUIDED_TOOL])
    reqs, keys = [], []
    for (name, guide), p in zip(GUIDED_REQUESTS, ps):
        if name in ("tool", "schema"):
            sp = SamplingParams(max_tokens=64, temperature=0.0, **(dict(guided_regex=tool_regex) if name == "tool" else {}))
            reqs.append(([Message("user", p)], sp, [GUIDED_TOOL]))
            keys.append(tool_prompt(p))
        else:
            sp = SamplingParams(max_tokens=64 if guide else 96, temperature=0.0, ignore_eos=not guide, **guide)
            reqs.append((p, sp, None))
            keys.append(p)
    cancel = 0
    sched, bm = engine._handler.scheduler, inner.block_manager
    free_before = bm.num_free_blocks + bm.num_blocks_in_prefix_cache
    steps_log, _, _, micro = watch_steps(inner, (k1,))
    t0 = time.monotonic()
    results = asyncio.run(guided_async_serve(engine, reqs, cancel))
    wall = time.monotonic() - t0
    deadline = time.monotonic() + GUIDED_AWAIT_S
    while sched._requests or bm.num_free_blocks + bm.num_blocks_in_prefix_cache != free_before:
        if time.monotonic() > deadline:
            fail(f"{tag}: {len(sched._requests)} requests still held, "
                 f"{free_before - bm.num_free_blocks - bm.num_blocks_in_prefix_cache} blocks not returned")
        time.sleep(0.01)
    torch.cuda.synchronize()
    unwatch_steps(inner)
    if failed_steps:
        fail(f"{tag}: the loop logged {len(failed_steps)} failed steps: {failed_steps[0]}")
    for (T, S, decode_only, runs, got), n in zip(steps_log, micro):
        if got != runs * L:
            fail(f"{tag}: a dispatch of T={T}, S={S} ({runs} device runs) launched K1 {got} times, "
                 f"expected {runs * L}")
    rows = []
    for i, (key, r) in enumerate(zip(keys, results)):
        cancelled, visible = done.get(key, (None, None))
        final = inner.tokenizer.decode(visible) if visible is not None else None
        row = dict(request=i, chat=reqs[i][2] is not None, guided=reqs[i][1].has_guided, items=r["items"],
                   ttft_s=r["ttft_s"], cancelled=bool(cancelled), tokens=len(visible or ()))
        if i == cancel:
            ok = cancelled and r["items"] == GUIDED_CANCEL_AFTER and len(visible) < reqs[i][1].max_tokens
        else:
            ok = (not cancelled and r["last"] is not None and r["last"].finished and r["last"].status.ok
                  and r["text"] == final)
        row["ok"] = bool(ok)
        rows.append(row)
    tool_text = results[[n for n, _ in GUIDED_REQUESTS].index("tool")]["text"]
    emit(dict(phase=f"{tag}_e2e", requests=rows, wall_s=wall, engine_steps=len(steps_log),
              k1_launches=sum(st[4] for st in steps_log),
              captured_in_serve=sum(1 for st, n in zip(steps_log, micro) if st[3] == 2 * n),
              mean_ttft_s=statistics.fmean(r["ttft_s"] for r in rows), free_blocks_before=free_before,
              tool_text=tool_text[:160], card=card["nvidia_smi"]))
    bad = [r["request"] for r in rows if not r["ok"]]
    if bad:
        fail(f"{tag}: requests {bad} did not stream their final text (or the cancel did not hold)")
    return sum(st[4] for st in steps_log)


def phase_guided(torch, card):
    """Phase 21 (see the module docstring). Returns K1's launches on its
    main paths: the guided and unconstrained serves with graphs, and the
    AsyncLLMEngine serves."""
    import logging

    from scalellm_tpu_torch import AsyncLLMEngine, SamplingParams
    from scalellm_tpu_torch.constrained.fsm import START
    from scalellm_tpu_torch.constrained.guided import token_vocab_bytes
    from scalellm_tpu_torch.constrained.tokenmap import GuidedState
    from scalellm_tpu_torch.ops import attention

    k1 = attention.ragged_paged_attention_cuda
    L = TINYLLAMA["num_hidden_layers"]
    want = lambda T, S, decode_only: {k1.__name__: L}  # noqa: E731  (K1 once a layer a step)
    root = tempfile.mkdtemp(prefix="scalellm_guided_")
    llm = engine = model = None
    prep_log = []
    real_prepare = time_prepare(prep_log)
    failed_steps = []

    class StepFailures(logging.Handler):
        def emit(self, record):
            if "scheduler step failed" in record.getMessage():
                failed_steps.append(record.getMessage())

    step_log = logging.getLogger("scalellm_tpu_torch.handlers.llm_handler")
    watcher = StepFailures()
    step_log.addHandler(watcher)
    try:
        t0 = time.monotonic()
        write_checkpoint(torch, root, TINYLLAMA)
        with open(os.path.join(root, "tokenizer.json"), "w") as f:
            json.dump(guided_tokenizer_json(TINYLLAMA["vocab_size"]), f)
        emit(dict(phase="guided_checkpoint", model="tinyllama", vocab=TINYLLAMA["vocab_size"],
                  write_s=time.monotonic() - t0))

        runs, prep = {}, {}
        for mode in ("graphs", "eager"):
            graphs = mode == "graphs"
            t0 = time.monotonic()
            llm = serving_llm(root, graphs, "sync")
            torch.cuda.synchronize()
            handler = llm._handler
            engine = handler.engine
            emit(dict(phase=serve_setup("guided", "sync" if graphs else "eager"), graphs=graphs,
                      load_s=time.monotonic() - t0, kv_blocks=engine.block_manager.options.num_blocks,
                      **graph_stats(engine)))
            if graphs:
                # The vocabulary's bytes, then the schema's FSM: built, then
                # from the handler's cache, then its first mask row.
                t0 = time.monotonic()
                vocab = token_vocab_bytes(handler.tokenizer)
                t_vocab = time.monotonic() - t0
                sp = SamplingParams(guided_json=GUIDED_SCHEMA)
                t0 = time.monotonic()
                fsm = handler._guided_fsm(sp)
                t_build = time.monotonic() - t0
                t0 = time.monotonic()
                cached = handler._guided_fsm(sp)
                t_cached = time.monotonic() - t0
                t0 = time.monotonic()
                fsm.row(START)
                t_row = time.monotonic() - t0
                emit(dict(phase="guided_fsm", vocab_ids=len(vocab), mask_words=fsm.n_words,
                          vocab_bytes_s=t_vocab, schema_build_s=t_build, schema_cached_s=t_cached,
                          cache_hit=cached is fsm, first_row_s=t_row, dfa_states=int(fsm.dfa.trans.shape[0]),
                          card=card["nvidia_smi"]))
            # Every constraint of the traffic compiled before the timed serve,
            # as a server that has seen it keeps it (the cold path is the
            # async serve's first pass below); each first build timed.
            builds = {}
            for (name, _), sp in zip(GUIDED_REQUESTS, guided_traffic(SEED)[1]):
                if sp.has_guided:
                    t0 = time.monotonic()
                    handler._guided_fsm(sp)
                    builds[name] = time.monotonic() - t0
            if graphs:
                emit(dict(phase="guided_fsm_builds", seconds=builds, card=card["nvidia_smi"]))
            del prep_log[:]
            # The eager serve's figures are not compared: no profiled run.
            runs[mode] = serve(torch, card, "guided", llm, (k1,), want, graphs, "sync", traffic=guided_traffic,
                               profiled=graphs)
            prep[mode] = list(prep_log)
            if graphs:
                check_guided_outputs(card, "guided", runs[mode]["outs"])
                # The unconstrained sync serve on the same engine, after
                # (the eager engine serves the guided traffic first too), on
                # other prompts (no prefix-cache hits on the guided ones).
                del prep_log[:]
                runs["free"] = serve(torch, card, "guided_free", llm, (k1,), want, True, "sync",
                                     traffic=lambda seed: (prompts(seed + 4), SamplingParams(
                                         max_tokens=32, temperature=0.0, ignore_eos=True)))
                prep["free"] = list(prep_log)
                # Each guided request's mask at its first decode step.
                masks = {}
                for (name, _), p, sp in zip(GUIDED_REQUESTS, *guided_traffic(SEED)):
                    ids, gen = runs[mode]["ids"][p]
                    if sp.has_guided and len(gen) >= 2:
                        g = GuidedState(handler._guided_fsm(sp))
                        g.advance(gen[0])
                        if not g.finished:
                            masks[name] = (ids, gen, g.mask().copy())
                engine = handler = None
                close_llm(torch, card, "guided", llm)
                llm = None
        compare_serves(card, "guided", runs["graphs"], runs["eager"])
        model = engine.model
        engine = handler = None
        close_llm(torch, card, "guided_eager", llm)
        llm = None
        guided_kernel_check(torch, card, model, masks)
        model = None
        torch.cuda.empty_cache()

        def prep_ms(log, guided):
            ms = [m for m, g in log if g == guided]
            return dict(calls=len(ms), mean_ms=statistics.fmean(ms) if ms else None,
                        median_ms=statistics.median(ms) if ms else None)

        fig = lambda r: {k: r["figures"][k] for k in ("output_tok_per_s", "mean_ttft_s", "decode_step_ms",  # noqa: E731
                                                      "idle_share", "engine_steps", "host_ms_per_dispatch",
                                                      "wall_s", "device_busy_ms")}
        emit(dict(phase="guided_cost", guided=fig(runs["graphs"]), unconstrained=fig(runs["free"]),
                  guided_eager=fig(runs["eager"]),
                  prepare_ms=dict(guided_rows=prep_ms(prep["graphs"], True),
                                  no_guided_rows=prep_ms(prep["graphs"], False),
                                  unconstrained_serve=prep_ms(prep["free"], False)),
                  output_tokens=dict(guided=sum(o.usage.num_generated_tokens for o in runs["graphs"]["outs"]),
                                     unconstrained=sum(o.usage.num_generated_tokens for o in runs["free"]["outs"])),
                  card=card["nvidia_smi"]))
        launches = runs["free"]["launches"][k1.__name__] + runs["graphs"]["launches"][k1.__name__]

        # AsyncLLMEngine on a fresh engine (its defaults: graphs, async
        # stepping, the "fast" warmup), stepping on the handler's loop
        # thread (guided_async_pass).
        t0 = time.monotonic()
        engine = AsyncLLMEngine(root, devices=DEVICE)
        torch.cuda.synchronize()
        inner = engine._handler.engine
        emit(dict(phase="guided_async_setup", load_s=time.monotonic() - t0,
                  kv_blocks=inner.block_manager.options.num_blocks, **graph_stats(inner)))
        sched = engine._handler.scheduler
        done = {}
        real_finish = sched._finish_request

        def finish(request):
            seq = request.sequences[0]
            visible = seq.token_ids[seq.num_prompt_tokens : seq.num_resolved_tokens - seq._num_hidden_tail_tokens]
            done[request.prompt] = (request.is_cancelled, list(visible))
            real_finish(request)

        sched._finish_request = finish
        engine.start()
        # Twice: "cold", each constraint compiled on first use inside the
        # serve (on a handling thread, beside the loop), then "warm", new
        # prompts under the same constraints (the handler's cache).
        async_k1 = 0
        for n_pass, tag in enumerate(("guided_async_cold", "guided_async_warm")):
            async_k1 += guided_async_pass(torch, card, tag, engine, inner, done, prompts(SEED + 2 + n_pass),
                                          failed_steps)
        inner = sched = real_finish = finish = None
        close_llm(torch, card, "guided_async", engine, close=engine.stop)
        engine = None
        return launches + async_k1
    finally:
        from scalellm_tpu_torch.engine.batch import Batch

        Batch.prepare_model_inputs = real_prepare
        step_log.removeHandler(watcher)
        model = None
        if llm is not None:
            llm.close()
        if isinstance(engine, AsyncLLMEngine):
            engine.stop()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ phase 22

SERVER_AWAIT_S = 120  # every client request, await and wait of phase 22
SERVER_MODEL = "tinyllama"  # the served model's name (--served-model-name)
SERVER_TOOL_TOKENS = 192  # the forced tool call's max_tokens: its language ends within it
CLI_READY_S = 180  # the CLI server's /health after its start: torch's import, the load, its warmup
CLI_STOP_S = 30  # the CLI server's exit after SIGTERM
# Phase 22's invalid bodies: the JAX package's server's status and message
# for each (its api_protocol, SamplingParams.verify and handler).
SERVER_REFUSALS = {
    "negative_temperature": (dict(prompt="x", temperature=-1.0), 400, "temperature must be non-negative"),
    "over_context": (dict(prompt="x" * 2100, max_tokens=4), 400,
                     "prompt (2100 tokens) exceeds max context length 2048"),
}


class ServerLoop:
    """An asyncio event loop on a thread of its own, which phase 22's HTTP
    server (and gateway) run on, as in the server process."""

    def __init__(self):
        import asyncio
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="server-loop", daemon=True)
        self.thread.start()

    def run(self, coro):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(SERVER_AWAIT_S)

    def close(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(SERVER_AWAIT_S)
        if self.thread.is_alive():
            fail("phase 22: the server's event loop did not stop")
        self.loop.close()


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_call(url, body=None):
    """One request to a server of phase 22 (GET without a body): (status,
    JSON, or an SSE response's chunks up to [DONE], or text; seconds to the
    whole response or to the first SSE chunk; seconds to the end)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=SERVER_AWAIT_S) as r:
            kind = r.headers.get("Content-Type", "")
            if kind.startswith("text/event-stream"):
                chunks, first = [], None
                for raw in r:
                    line = raw.decode().strip()
                    if not line.startswith("data: "):
                        continue
                    first = time.monotonic() - t0 if first is None else first
                    if line == "data: [DONE]":
                        break
                    chunks.append(json.loads(line[len("data: "):]))
                return r.status, chunks, first, time.monotonic() - t0
            raw = r.read()
            out = json.loads(raw) if kind.startswith("application/json") else raw.decode()
            return r.status, out, time.monotonic() - t0, time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.monotonic() - t0, time.monotonic() - t0


def prometheus_values(text):
    """{metric line name: value} of a /metrics payload."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            out[name] = float(value)
    return out


def server_traffic(ps):
    """Pass 2's 8 requests on the prompts `ps`, each (path, body): 4
    completions, the last two streamed, then 4 chat completions, the last
    two streamed and the last a forced call of GUIDED_TOOL (tool_choice
    names it); greedy, 32 tokens (the tool call: up to
    SERVER_TOOL_TOKENS, ending with the call)."""
    greedy = dict(model=SERVER_MODEL, max_tokens=32, temperature=0.0, ignore_eos=True)
    reqs = [("/v1/completions", dict(greedy, prompt=p, stream=i >= 2)) for i, p in enumerate(ps[:4])]
    for i, p in enumerate(ps[4:8]):
        body = dict(greedy, messages=[{"role": "user", "content": p}], stream=i >= 2)
        if i == 3:
            body.update(tools=[GUIDED_TOOL], tool_choice={"type": "function", "function": {"name": "get_weather"}},
                        max_tokens=SERVER_TOOL_TOKENS, ignore_eos=False)
        reqs.append(("/v1/chat/completions", body))
    return reqs


def tool_args_valid(arguments):
    """Whether a call's arguments are JSON of GUIDED_TOOL's schema."""
    try:
        args = json.loads(arguments)
    except ValueError:
        return False
    props = GUIDED_TOOL["function"]["parameters"]["properties"]
    return (isinstance(args, dict) and set(args) <= set(props) and isinstance(args.get("city"), str)
            and len(args["city"]) <= props["city"]["maxLength"] and args.get("unit", "C") in props["unit"]["enum"])


def server_answer(path, body, out):
    """What one answer of pass 2 says, whether through HTTP (`out` the JSON
    or the SSE chunks) or straight from the engine (`out` the list of
    RequestOutputs): the text (a stream's deltas put together), the finish
    reasons in order, the tool calls, the completion tokens in the usage."""
    if isinstance(out, list) and out and not isinstance(out[0], dict):  # RequestOutputs
        from scalellm_tpu_torch.utils.tools import parse_tool_calls

        text = "".join(so.text for o in out for so in o.outputs)
        finishes = [so.finish_reason.to_api_string() for o in out for so in o.outputs if so.finish_reason]
        calls = []
        if body.get("tools"):
            content, parsed = parse_tool_calls(text)
            calls = [dict(name=c.name, arguments=c.arguments) for c in parsed]
            finishes = ["tool_calls" if parsed and f == "stop" else f for f in finishes]
        return dict(text=text, finishes=finishes, calls=calls, tokens=out[-1].usage.num_generated_tokens)
    if body.get("stream"):
        key = "text" if path == "/v1/completions" else "content"
        deltas = [c["choices"][0] if path == "/v1/completions" else c["choices"][0]["delta"] for c in out]
        calls = [dict(name=tc["function"]["name"], arguments=tc["function"]["arguments"])
                 for d in deltas for tc in d.get("tool_calls", [])]
        return dict(text="".join(d.get(key) or "" for d in deltas),
                    finishes=[c["choices"][0]["finish_reason"] for c in out if c["choices"][0]["finish_reason"]],
                    calls=calls, tokens=None)
    choice = out["choices"][0]
    msg = choice.get("message", {})
    calls = [dict(name=tc["function"]["name"], arguments=tc["function"]["arguments"])
             for tc in msg.get("tool_calls", [])]
    return dict(text=choice["text"] if path == "/v1/completions" else msg.get("content") or "",
                finishes=[choice["finish_reason"]], calls=calls, tokens=out["usage"]["completion_tokens"])


class ServerWatch:
    """Phase 22's view of the served engine: each finished request's prompt
    ids and generated ids (all, and those that decode to text) by prompt
    text, noted by the scheduler (`take()` hands them over and starts
    afresh), and `quiesce()`, which waits for the engine to go idle."""

    def __init__(self, engine):
        self.inner, self.sched = engine._handler.engine, engine._handler.scheduler
        bm = self.inner.block_manager
        self.idle = bm.num_free_blocks + bm.num_blocks_in_prefix_cache
        self._real, self.ids = self.sched._finish_request, {}
        self.sched._finish_request = self._finish

    def _finish(self, request):
        seq = request.sequences[0]
        n = seq.num_prompt_tokens
        self.ids[request.prompt] = (list(seq.token_ids[:n]), list(seq.token_ids[n: seq.num_resolved_tokens]),
                                    list(seq.token_ids[n: seq.num_resolved_tokens - seq._num_hidden_tail_tokens]))
        self._real(request)

    def take(self):
        ids, self.ids = self.ids, {}
        return ids

    def quiesce(self, cold=False):
        """Wait until the engine holds no request and every block is free
        or cached; with cold, evict the prefix cache, so that the next pass
        builds the same steps as a first serve of its prompts."""
        bm = self.inner.block_manager
        deadline = time.monotonic() + SERVER_AWAIT_S
        while self.sched._requests or bm.num_free_blocks + bm.num_blocks_in_prefix_cache != self.idle:
            if time.monotonic() > deadline:
                fail(f"phase 22: {len(self.sched._requests)} requests still held, "
                     f"{self.idle - bm.num_free_blocks - bm.num_blocks_in_prefix_cache} blocks not returned")
            time.sleep(0.01)
        if cold and bm._prefix_cache is not None:
            bm._prefix_cache.evict(bm.num_blocks_in_prefix_cache)
            if bm.num_blocks_in_prefix_cache or bm.num_free_blocks != self.idle:
                fail("phase 22: the prefix cache kept blocks")

    def remove(self):
        self.sched.__dict__.pop("_finish_request", None)


def held_launches(tag, steps_log, micro, L):
    """Fail unless every dispatch of a pass launched K1 once a layer a
    step (a replayed step counted as its graph counted at its capture).
    Returns (K1 launches, dispatches that captured a graph)."""
    if not steps_log:
        fail(f"{tag}: no engine step ran")
    for T, S, decode_only, runs, got in steps_log:
        if got != runs * L:
            fail(f"{tag}: a dispatch of T={T}, S={S} ({runs} device runs) launched K1 {got} times, "
                 f"expected {runs * L}")
    return sum(st[4] for st in steps_log), sum(1 for st, n in zip(steps_log, micro) if st[3] == 2 * n)


def near_ties(torch, tag, model, ref, got):
    """Hold each request's generated ids (`got`: prompt -> ids of
    ServerWatch) to `ref`'s for the same prompt: the same ids, or each
    differing token a greedy choice up to kernel rounding
    (teacher_forced_gap within LOGITS_TOL). Returns (requests differing,
    largest gap)."""
    gaps = []
    for prompt, (prompt_ids, gen, _) in got.items():
        if gen != ref[prompt][1]:
            gaps.append(teacher_forced_gap(torch, model, prompt_ids, gen))
    if any(not g <= LOGITS_TOL for g in gaps):
        fail(f"{tag}: a request's tokens differ from its reference's by more than kernel rounding "
             f"(largest gap {max(gaps)} > {LOGITS_TOL})")
    return len(gaps), max(gaps, default=0.0)


def server_pass(torch, tag, watch, L, run, reqs):
    """One timed pass: run(reqs) sends the requests and returns
    [(answer, seconds to the first chunk or to the whole answer)] in order.
    Returns the answers, the ids noted and the pass's figures (K1's
    launches among them); fails unless K1 ran once a layer a step and no
    graph was captured."""
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS

    compiles = COUNTERS.get("num_mid_serve_compiles")
    ttft_hist = HISTOGRAMS.get("time_to_first_token_latency_seconds")
    ttft_before = (ttft_hist.total, ttft_hist.count)
    steps_log, _, _, micro = watch_steps(watch.inner, (attention.ragged_paged_attention_cuda,))
    t0 = time.monotonic()
    results = run(reqs)
    wall = time.monotonic() - t0
    watch.quiesce()
    torch.cuda.synchronize()
    unwatch_steps(watch.inner)
    launches, captured = held_launches(tag, steps_log, micro, L)
    compiles = COUNTERS.get("num_mid_serve_compiles") - compiles
    if compiles or captured:
        fail(f"{tag}: {compiles} graphs were captured inside the timed pass ({captured} dispatches)")
    ids = watch.take()
    tokens = sum(len(gen) for _, gen, _ in ids.values())
    ttft = [first for _, first in results]
    # The engine's own TTFT (its histogram: request arrival to first token).
    server_ttft = (ttft_hist.total - ttft_before[0]) / max(ttft_hist.count - ttft_before[1], 1)
    figures = dict(wall_s=wall, output_tokens=tokens, output_tok_per_s=tokens / wall, ttft_s=ttft,
                   mean_ttft_s=statistics.fmean(ttft), server_mean_ttft_s=server_ttft, engine_steps=len(steps_log),
                   k1_launches=launches, mid_serve_compiles=compiles)
    return [a for a, _ in results], ids, figures


def server_call(url, body=None):
    """http_call that fails unless the answer is 200: (answer, seconds to
    the first chunk or to the whole answer)."""
    status, out, first, _ = http_call(url, body)
    if status != 200:
        fail(f"phase 22: {url} answered {status}: {out}")
    return out, first


def phase_servers(torch, card):
    """Phase 22 (see the module docstring). Returns K1's launches on its
    main paths: the two passes through the HTTP server, the gRPC pass and
    the gateway's completion."""
    import asyncio
    import concurrent.futures
    import signal

    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    from scalellm_tpu_torch import Message
    from scalellm_tpu_torch.serve.api_protocol import ChatCompletionRequest, CompletionRequest
    from scalellm_tpu_torch.serve.api_server import ApiServer, build_arg_parser, engine_from_args
    from scalellm_tpu_torch.serve.gateway import Gateway

    L = TINYLLAMA["num_hidden_layers"]
    root = tempfile.mkdtemp(prefix="scalellm_servers_")
    engine = watch = server_loop = api = gw = grpc_srv = channel = pool = cli = None
    try:
        t0 = time.monotonic()
        write_checkpoint(torch, root, TINYLLAMA)
        emit(dict(phase="serve_checkpoint", model="tinyllama", write_s=time.monotonic() - t0))

        # The engine as the CLI builds it from its flags (graphs, async
        # stepping, the "full" warmup), served by ApiServer on its own
        # thread's event loop, bound to a free port.
        port = free_port()
        flags = ["--model", root, "--served-model-name", SERVER_MODEL, "--host", "127.0.0.1", "--port", str(port),
                 "--devices", DEVICE]
        args = build_arg_parser().parse_args(flags)
        t0 = time.monotonic()
        engine = engine_from_args(args)
        torch.cuda.synchronize()
        inner = engine._handler.engine
        emit(dict(phase="serve_setup", warmup_mode=args.warmup_mode, max_seqs_per_batch=args.max_seqs_per_batch,
                  max_tokens_per_batch=args.max_tokens_per_batch, load_s=time.monotonic() - t0,
                  kv_blocks=inner.block_manager.options.num_blocks, **graph_stats(inner), card=card["nvidia_smi"]))
        watch = ServerWatch(engine)
        server_loop = ServerLoop()
        api = ApiServer(engine, SERVER_MODEL)
        engine.start()
        server_loop.run(api.http.start("127.0.0.1", port))
        base = f"http://127.0.0.1:{port}"
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=8, thread_name_prefix="client")
        ps = prompts()
        greedy = dict(model=SERVER_MODEL, max_tokens=32, temperature=0.0, ignore_eos=True)

        # Endpoints.
        health = http_call(base + "/health")[:2]
        models = server_call(base + "/v1/models")[0]
        config = server_call(base + "/config")[0]
        refusals = {name: http_call(base + "/v1/completions", body)[:2]
                    for name, (body, _, _) in SERVER_REFUSALS.items()}
        refusals = {n: (status, out["error"]["message"]) for n, (status, out) in refusals.items()}
        emit(dict(phase="serve_endpoints", health=health, models=models["data"], config_devices=config["devices"],
                  config_model_args=config["model_args"], refusals=refusals,
                  expected_refusals={n: r[1:] for n, r in SERVER_REFUSALS.items()}, card=card["nvidia_smi"]))
        if (health != (200, "OK") or [m["id"] for m in models["data"]] != [SERVER_MODEL]
                or config["devices"] != DEVICE or config["model_args"]["n_layers"] != L
                or config["model_args"]["hidden_size"] != TINYLLAMA["hidden_size"]
                or any(refusals[n] != r[1:] for n, r in SERVER_REFUSALS.items())):
            fail("serve_endpoints: an endpoint answered otherwise than expected")

        # The reference texts: each prompt alone, straight to the engine.
        async def alone(p):
            sp = CompletionRequest.from_json(dict(greedy, prompt=p)).to_sampling_params()
            return [o async for o in await engine.schedule_async(p, sp)]

        watch.quiesce(cold=True)
        direct = {}
        for p in ps:
            direct[p] = asyncio.run(asyncio.wait_for(alone(p), SERVER_AWAIT_S))[-1].outputs[0].text
            watch.quiesce()
        direct_ids = watch.take()

        # Pass 1: the 8 prompts one at a time through /v1/completions, on a
        # cold prefix cache as the reference texts were.
        metrics_before = prometheus_values(server_call(base + "/metrics")[0])
        watch.quiesce(cold=True)
        pass1_reqs = [("/v1/completions", dict(greedy, prompt=p)) for p in ps]
        answers, pass1_ids, fig1 = server_pass(
            torch, "serve_pass1", watch, L, lambda reqs: [server_call(base + path, b) for path, b in reqs], pass1_reqs)
        metrics_after = prometheus_values(server_call(base + "/metrics")[0])
        texts = [a["choices"][0]["text"] for a in answers]
        grown = {k: metrics_after.get(k, 0) - metrics_before.get(k, 0)
                 for k in ("request_handling_total", "time_to_first_token_latency_seconds_count",
                           "time_to_first_token_latency_seconds_sum")}
        differing, gap = near_ties(torch, "serve_pass1", inner.model, direct_ids, pass1_ids)
        emit(dict(phase="serve_pass1_e2e", requests=len(texts), texts_equal=texts == [direct[p] for p in ps],
                  ids_differing=differing, largest_gap=gap, metrics_grown=grown, **fig1,
                  card=card["nvidia_smi"]))
        if texts != [direct[p] for p in ps]:
            fail("serve_pass1: a text through the server differs from the same engine's for the prompt alone: "
                 f"{[i for i, p in enumerate(ps) if texts[i] != direct[p]]}")
        if (any(a["usage"]["completion_tokens"] != 32 or a["choices"][0]["finish_reason"] != "length"
                for a in answers) or grown["request_handling_total"] != 8
                or grown["time_to_first_token_latency_seconds_count"] != 8):
            fail(f"serve_pass1: a request did not finish with 32 tokens, or /metrics grew by {grown}")

        # Pass 2: 8 clients at once, then the same 8 requests straight to
        # the engine, each on a cold prefix cache.
        def concurrent_http(reqs):
            return list(pool.map(lambda r: server_call(base + r[0], r[1]), reqs))

        def engine_args(path, body):
            """((prompt or messages, SamplingParams), tools) of a request,
            as the server's handlers build them."""
            if path == "/v1/completions":
                req = CompletionRequest.from_json(body)
                return (req.prompt, req.to_sampling_params()), None
            req = ChatCompletionRequest.from_json(body)
            return ([Message.from_dict(m) for m in req.messages], req.to_sampling_params()), (
                req.tools if req.tools_active else None)

        def prompt_of(path, body):
            (msg, _), tools = engine_args(path, body)
            return msg if path == "/v1/completions" else engine._handler.apply_chat_template(msg, tools=tools)

        def concurrent_direct(reqs):
            async def one(path, body):
                (msg, sp), tools = engine_args(path, body)
                t0 = time.monotonic()
                if path == "/v1/completions":
                    stream = await engine.schedule_async(msg, sp, stream=body["stream"])
                else:
                    stream = await engine.schedule_chat_async(msg, sp, stream=body["stream"], tools=tools)
                outs, first = [], None
                async for o in stream:
                    first = time.monotonic() - t0 if first is None else first
                    outs.append(o)
                return outs, first

            async def run_all():
                return await asyncio.gather(*(one(*r) for r in reqs))

            return asyncio.run(asyncio.wait_for(run_all(), SERVER_AWAIT_S))

        # Pass 2 three times, each on a cold prefix cache: through the
        # server with the tool call's constraint compiled inside the pass
        # (its first use: "cold"), straight to the engine, and through the
        # server again with the constraint cached ("warm"; the HTTP layer's
        # cost is warm against straight).
        reqs2 = server_traffic(ps)
        keys = [prompt_of(*r) for r in reqs2]
        free = [k for k, (_, body) in zip(keys, reqs2) if not body.get("tools")]
        runs = {}
        for name, run in (("cold", concurrent_http), ("direct", concurrent_direct), ("warm", concurrent_http)):
            watch.quiesce(cold=True)
            runs[name] = server_pass(torch, f"serve_pass2_{name}", watch, L, run, reqs2)
        # The unconstrained requests' ids: the completions' against pass 1's
        # (the same prompts), the chats' against the straight pass's.
        ref = {k: pass1_ids.get(k, runs["direct"][1][k]) for k in free}
        summary, faults = {}, []
        for name, (answers2, ids2, fig) in runs.items():
            rows = []
            for i, ((path, body), key, a) in enumerate(zip(reqs2, keys, answers2)):
                _, gen, visible = ids2[key]
                got = server_answer(path, body, a)
                rows.append(dict(request=i, path=path, stream=body["stream"], tool=bool(body.get("tools")),
                                 tokens=len(gen), text=got["text"][:80], finishes=got["finishes"], calls=got["calls"],
                                 ttft_s=fig["ttft_s"][i]))
                if body.get("tools"):
                    ok = (got["finishes"] == ["tool_calls"] and len(got["calls"]) == 1
                          and got["calls"][0]["name"] == "get_weather" and tool_args_valid(got["calls"][0]["arguments"]))
                else:
                    ok = (got["finishes"] == ["length"] and len(gen) == 32 and got["tokens"] in (None, 32)
                          and got["text"] == inner.tokenizer.decode(visible))
                if not ok:
                    faults.append((name, i))
            differing, gap = near_ties(torch, f"serve_pass2_{name}", inner.model, ref,
                                       {k: ids2[k] for k in free if name != "direct" or k in pass1_ids})
            summary[name] = dict(requests=rows, ids_differing=differing, largest_gap=gap, **fig)
        emit(dict(phase="serve_pass2_e2e", **summary,
                  http_over_direct_tok_per_s=runs["warm"][2]["output_tok_per_s"] / runs["direct"][2]["output_tok_per_s"],
                  cold_over_warm_wall=runs["cold"][2]["wall_s"] / runs["warm"][2]["wall_s"], card=card["nvidia_smi"]))
        if faults:
            fail(f"serve_pass2: requests {faults} did not answer as expected (the serve_pass2_e2e line's rows)")
        fig2 = runs["warm"][2]
        launches = fig1["k1_launches"] + runs["cold"][2]["k1_launches"] + fig2["k1_launches"]

        # The device's idle share of pass 2: a profiled repeat on other text
        # (every thread traced: the engine steps on its loop thread), its
        # device time against the warm pass's wall.
        watch.quiesce(cold=True)
        steps_log, _, _, _ = watch_steps(inner, ())
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
            concurrent_http(server_traffic(prompts(SEED + 1)))
            watch.quiesce()
            torch.cuda.synchronize()
        profiled_wall = time.monotonic() - t0
        unwatch_steps(inner)
        watch.take()
        breakdown = device_breakdown(prof, fig2["wall_s"], max(len(steps_log), 1))
        del prof
        emit(dict(phase="serve_pass2_profile", engine_steps=len(steps_log), profiled_wall_s=profiled_wall,
                  unprofiled_wall_s=fig2["wall_s"], **breakdown, card=card["nvidia_smi"]))

        # /profile: a torch.profiler trace of two requests, written when it
        # stops; it must name K1's kernel.
        started = server_call(base + "/profile/start", dict(log_dir=os.path.join(root, "profile")))[0]
        for p in ps[2:4]:
            server_call(base + "/v1/completions", dict(greedy, prompt=p, max_tokens=8))
        stopped = server_call(base + "/profile/stop", {})[0]
        with open(stopped["trace"]) as f:
            trace = f.read()
        emit(dict(phase="serve_profile_endpoint", started=started, stopped=stopped, trace_bytes=len(trace),
                  names_k1="ragged_paged_attention" in trace, card=card["nvidia_smi"]))
        if "ragged_paged_attention" not in trace:
            fail("serve_profile_endpoint: the trace names no K1 kernel")
        del trace
        watch.quiesce()
        watch.take()

        # gRPC (grpc and protobuf are on the card's machine): pass 1's
        # prompts through the port's gRPC server on the same engine, then
        # one through the port's gateway in front of it.
        import grpc

        from scalellm_tpu_torch.serve import grpc_server
        from scalellm_tpu_torch.serve.pb import llm_pb2

        gport = free_port()
        grpc_srv = grpc_server.serve(engine._handler, SERVER_MODEL, "127.0.0.1", gport)
        channel = grpc.insecure_channel(f"127.0.0.1:{gport}")
        complete = channel.unary_stream("/scalellm_tpu.Completion/Complete",
                                        request_serializer=llm_pb2.CompletionRequest.SerializeToString,
                                        response_deserializer=llm_pb2.CompletionResponse.FromString)

        def grpc_sequential(reqs):
            out = []
            for _, body in reqs:
                t0 = time.monotonic()
                resp = list(complete(llm_pb2.CompletionRequest(
                    model=SERVER_MODEL, prompt=body["prompt"], sampling=llm_pb2.SamplingParams(
                        max_tokens=32, temperature=0.0, ignore_eos=True)), timeout=SERVER_AWAIT_S))
                out.append((resp[-1].choices[0].text, time.monotonic() - t0))
            return out

        watch.quiesce(cold=True)
        grpc_texts, _, fig_grpc = server_pass(torch, "serve_grpc", watch, L, grpc_sequential, pass1_reqs)

        async def start_gateway(gw_port):
            g = Gateway([f"127.0.0.1:{gport}"])
            await g.http.start("127.0.0.1", gw_port)
            return g

        gw_port = free_port()
        gw = server_loop.run(start_gateway(gw_port))
        watch.quiesce(cold=True)
        gw_answers, _, fig_gw = server_pass(
            torch, "serve_gateway", watch, L,
            lambda reqs: [server_call(f"http://127.0.0.1:{gw_port}{path}", b) for path, b in reqs], pass1_reqs[3:4])
        gw_text = gw_answers[0]["choices"][0]["text"]
        emit(dict(phase="serve_grpc_e2e", texts_equal=grpc_texts == texts, gateway_text_equal=gw_text == texts[3],
                  **{k: fig_grpc[k] for k in ("wall_s", "output_tok_per_s", "mean_ttft_s", "k1_launches")},
                  gateway_ttft_s=fig_gw["mean_ttft_s"], gateway_k1_launches=fig_gw["k1_launches"],
                  card=card["nvidia_smi"]))
        if grpc_texts != texts or gw_text != texts[3]:
            fail("serve_grpc: a text through the gRPC server or the gateway differs from pass 1's")
        launches += fig_grpc["k1_launches"] + fig_gw["k1_launches"]
        server_loop.run(gw.close())
        gw = None
        channel.close()
        channel = None
        grpc_srv.stop(None).wait(SERVER_AWAIT_S)
        grpc_srv = None
        server_loop.run(api.http.stop())
        server_loop.close()
        server_loop = None
        pool.shutdown()
        pool = None
        watch.remove()
        watch = inner = None
        close_llm(torch, card, "serve", engine, close=engine.stop)
        engine = None

        # The CLI as users run it, in a process of its own: /health within
        # CLI_READY_S, pass 1's text for one prompt, exit 0 after SIGTERM.
        cli_port = free_port()
        cmd = [sys.executable, "-m", "scalellm_tpu_torch.serve.api_server", "--model", root, "--host", "127.0.0.1",
               "--port", str(cli_port), "--warmup-mode", "fast"] + (["--devices", DEVICE] if DEVICE != "cuda" else [])
        cli_log = os.path.join(root, "cli.log")
        t0 = time.monotonic()
        with open(cli_log, "w") as log:
            cli = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                                   stderr=subprocess.STDOUT)
        cli_base = f"http://127.0.0.1:{cli_port}"
        ready = None
        while time.monotonic() - t0 < CLI_READY_S and cli.poll() is None:
            try:
                if http_call(cli_base + "/health")[:2] == (200, "OK"):
                    ready = time.monotonic() - t0
                    break
            except OSError:
                time.sleep(0.25)
        answer = http_call(cli_base + "/v1/completions", dict(greedy, prompt=ps[3])) if ready else None
        cli.send_signal(signal.SIGTERM)
        t_term = time.monotonic()
        try:
            code = cli.wait(CLI_STOP_S)
        except subprocess.TimeoutExpired:
            code = None
        stop_s = time.monotonic() - t_term
        cli_text = answer[1]["choices"][0]["text"] if answer and answer[0] == 200 else None
        emit(dict(phase="serve_cli", args=cmd[3:], ready_s=ready, ready_limit_s=CLI_READY_S,
                  text_equal=cli_text == texts[3], exit_code=code, stop_s=stop_s, stop_limit_s=CLI_STOP_S,
                  card=card["nvidia_smi"]))
        if ready is None or cli_text != texts[3] or code != 0:
            with open(cli_log) as f:
                print(f.read()[-4000:], file=sys.stderr)
            fail(f"serve_cli: ready after {ready} s (limit {CLI_READY_S}), text equal {cli_text == texts[3]}, "
                 f"exit code {code} after SIGTERM")
        cli = None
        return launches
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait()
        if gw is not None:
            server_loop.run(gw.close())
        if channel is not None:
            channel.close()
        if grpc_srv is not None:
            grpc_srv.stop(None)
        if pool is not None:
            pool.shutdown(cancel_futures=True)
        if server_loop is not None:
            if api is not None:
                server_loop.run(api.http.stop())
            server_loop.close()
        if watch is not None:
            watch.remove()
        if engine is not None:
            engine.stop()
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------------------ phase 23

# Tensor parallelism: two ranks share the one card, so NCCL (which refuses
# two ranks on one device) gives way to gloo, and every rank's device is the
# card. Both ranks' KV caches get TP_BLOCKS blocks of 16 slots (no sizing
# from free memory: the other rank's weights are not there yet when one
# rank looks); the serves run eagerly and synchronously, as tensor
# parallelism does in this slice.
TP_DEVICES = "cuda:0,cuda:0"
TP_BLOCKS = 2048
TP_OPTIONS = dict(enable_cuda_graph=False, enable_async_scheduling=False, warmup_mode="off")
# The a2a check's tokens (phase 23d), split over the two ranks, and how
# long the driver waits for the ranks' results.
A2A_TOKENS = 256
A2A_TIMEOUT_S = 300


def rank_launches(engine, reset=False):
    """Every rank's kernel launch counts (ops.kernel_counters) by rank:
    DistributedLLMEngine.rank_launches, or this process's for the one engine
    of a tp 1 serve; `reset` sets them to 0 after reading. Each rank's
    "rms_prologue" is its launches with the RMSNorm prologue (K5, inside
    K2's pre-pass or K4's)."""
    from scalellm_tpu_torch.ops import kernel_counters

    if hasattr(engine, "rank_launches"):
        ranks = engine.rank_launches(reset)
    else:
        counters = kernel_counters()
        ranks = [{name: c.launches for name, c in counters.items()}]
        if reset:
            for c in counters.values():
                c.launches = 0
    for counts in ranks:
        counts["rms_prologue"] = sum(v for k, v in counts.items() if k.endswith("_prologue"))
    return ranks


def tp_a2a_rank(rank, coordinator, tokens, results):
    """A rank of phase 23 (d), in a process of its own (the spawn start
    method): layers/moe.py's moe_mlp_a2a over two gloo ranks on TP_DEVICES at
    Mixtral-8x7B's widths, on a random router and 8 random experts (N(0,
    0.02), the same on both ranks, from SEED) of which the rank holds 4, and
    this rank's half of `tokens` random hidden states; then the single-rank
    moe_mlp on all the tokens and every expert. Puts on `results` the
    largest error of the gathered a2a rows, the reference's largest
    magnitude and the a2a's milliseconds (host clock, the card
    synchronised)."""
    import torch

    from scalellm_tpu_torch.engine.distributed import rank_devices
    from scalellm_tpu_torch.layers.moe import moe_mlp, moe_mlp_a2a
    from scalellm_tpu_torch.parallel import collectives as C
    from scalellm_tpu_torch.parallel import multihost

    device = torch.device(rank_devices(TP_DEVICES, 2)[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.init_distributed(coordinator, 2, rank, "gloo")
    try:
        mesh = multihost.make_pod_mesh(tp=2, device=device)
        c = MIXTRAL_8X7B
        D, F, E, k = c["hidden_size"], c["intermediate_size"], c["num_local_experts"], c["num_experts_per_tok"]
        gen = torch.Generator(device=device).manual_seed(SEED)

        def rand(*shape, scale=0.02):
            return (torch.randn(*shape, generator=gen, device=device) * scale).to(torch.bfloat16)

        x, router = rand(tokens, D, scale=1.0), rand(E, D)
        experts = (rand(E, F, D), rand(E, F, D), rand(E, D, F))
        n, e = tokens // 2, E // 2
        with torch.inference_mode():
            sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
            sync()
            t0 = time.monotonic()
            y = moe_mlp_a2a(x[rank * n: (rank + 1) * n], router, *(w[rank * e: (rank + 1) * e] for w in experts), k,
                            True, c["hidden_act"], mesh=mesh)
            sync()
            ms = (time.monotonic() - t0) * 1e3
            got = C.all_gather(y, 0, mesh)
            want = moe_mlp(x, router, *experts, k, True, c["hidden_act"])
        results.put(dict(rank=rank, local_experts=e, rows=y.shape[0], ms=ms,
                         max_abs_err=(got - want).abs().max().item(), ref_max=want.abs().max().item(),
                         finite=bool(torch.isfinite(got).all())))
    finally:
        multihost.shutdown_distributed()


def phase_tp_a2a(torch, card):
    """Phase 23 (d): moe_mlp_a2a across two ranks, each a spawned process on
    the card (tp_a2a_rank), against the single-rank moe_mlp, within
    QUANT_TOL_MAX of the output's largest magnitude (bf16 products, f32
    sums)."""
    import multiprocessing
    import queue

    from scalellm_tpu_torch.engine.distributed import free_port

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    coordinator = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=tp_a2a_rank, args=(r, coordinator, A2A_TOKENS, results), daemon=True)
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        try:
            ranks = sorted((results.get(timeout=A2A_TIMEOUT_S) for _ in procs), key=lambda r: r["rank"])
        except queue.Empty:
            fail(f"tp a2a: no result within {A2A_TIMEOUT_S} s (exit codes {[p.exitcode for p in procs]})")
        for p in procs:
            p.join(60)
        if any(p.exitcode != 0 for p in procs):
            fail(f"tp a2a: the ranks exited with {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(60)
    emit(dict(phase="tp_a2a", tokens=A2A_TOKENS, ranks=ranks, tol=QUANT_TOL_MAX, card=card["nvidia_smi"]))
    for r in ranks:
        if not r["finite"] or not r["max_abs_err"] <= QUANT_TOL_MAX * r["ref_max"]:
            fail(f"tp a2a: rank {r['rank']}'s rows differ from moe_mlp by {r['max_abs_err']}")


def collective_share(prof):
    """From a profiled serve's raw events: the decode steps' mean host
    milliseconds (their "tp_step_decode" ranges on the driver) and the
    share of that time inside the collectives' ranges (collectives.RANGES;
    on gloo with CUDA tensors they hold the copies through the host and the
    wait for the card's queued work)."""
    from torch.autograd import DeviceType

    from scalellm_tpu_torch.parallel.collectives import RANGES

    steps, exchange = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            continue
        span = (e.start_ns() / 1e3, e.end_ns() / 1e3)
        name = e.name()
        if name == "tp_step_decode":
            steps.append(span)
        elif name in RANGES:
            exchange.append(span)

    def inside(spans):
        return union_ms([(max(a, s0), min(b, s1)) for a, b in spans for s0, s1 in steps
                         if min(b, s1) > max(a, s0)])

    total = union_ms(steps)
    if not steps:
        return dict(decode_steps=0, decode_step_ms=None, collective_share=None)
    return dict(decode_steps=len(steps), decode_step_ms=total / len(steps),
                collective_share=inside(exchange) / total)


def route_gaps(x, router_w, own_e, replayed_e, rows):
    """For a replayed routing: the (token, slot) choices of `replayed_e`
    that the serve's own router (`own_e`, on the same x) did not pick, on
    the token rows where `rows` (bool [T]) is true, and for each how far its
    router logit lies below the least logit the own router picked (f32, as
    softmax_topk computes them). Device tensors: the number of choices
    looked at, the number that differ and the largest gap (0 where none
    differs)."""
    import torch

    logits = x.float() @ router_w.float().T
    missed = ~(replayed_e[:, :, None] == own_e[:, None, :]).any(-1) & rows[:, None]
    cutoff = logits.gather(1, own_e).min(dim=1, keepdim=True).values
    gaps = torch.where(missed, cutoff - logits.gather(1, replayed_e), torch.zeros((), device=x.device))
    return rows.sum() * own_e.shape[1], missed.sum(), gaps.max()


def step_history(batch):
    """Each entry of a step: its sequence's tokens up to the last of this
    step's chunk (what every row of the chunk has seen), and the chunk's
    rows; the rows follow the entries in order."""
    return [(tuple(e.seq.token_ids[: e.seq.num_kv_cache_tokens() + e.num_tokens]), e.num_tokens)
            for e in batch.entries]


def tp_serve(torch, card, tag, path, tp, sp=False, routes=None, history=None, **kw):
    """Phase 4's traffic (8 prompts, 32 greedy tokens, after a warm-up
    request) through an LLM over `tp` ranks on the card (TP_DEVICES; tp 1:
    the card alone), synchronous and eager, one request-handling thread (so
    two serves build the same batches). Each dispatch's launches on the
    driver held to moe_step_launches; every rank's launches read back
    (rank_launches) and held equal to the driver's; the first step's and
    the first decode-only step's logits kept, and each request's logits
    rows of the steps that sampled its tokens, in order. An MoE model's
    routing during the timed serve: with tp 2 recorded into `routes` (a
    list; every rank routes the same replicated hidden states the same
    way), with tp 1 replayed from it, call by call (a near-tie in a router
    would otherwise send a token to another expert under the other serve's
    rounding, and the serves would part); the tp 1 serve's own router still
    runs on each call's hidden states, and every replayed choice it would
    not have made is counted with its router gap (route_gaps), which
    tp_compare holds within LOGITS_TOL: a fault of tp 2's routing cannot
    hide behind the replay. The gaps are taken on the rows whose sequence
    has seen the same tokens in both serves (`history`: each step's
    step_history, recorded with the routing and compared when it is
    replayed): a request whose greedy ids parted at a near tie feeds each
    serve another token from there, and its rows' routings part with it. Then 2 other prompts (16 tokens) under
    torch.profiler for the decode step's time and its share in collectives.
    Emits `{tag}_tp{tp}`. Returns the engine's LLM (open) and what it
    measured."""
    from torch.profiler import ProfilerActivity, profile

    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions

    t0 = time.monotonic()
    llm = LLM.__new__(LLM)
    llm._handler = LLMHandler(LLMHandlerOptions(
        model_path=path, devices=TP_DEVICES if tp > 1 else DEVICE, tp_size=tp, sequence_parallel=sp,
        num_blocks=TP_BLOCKS, num_handling_threads=1, **SERVE_ENVELOPE, **TP_OPTIONS, **kw))
    torch.cuda.synchronize()
    t_load = time.monotonic() - t0
    engine = llm._handler.engine
    model = engine.model
    llm.generate(["warm up the engine"], SamplingParams(max_tokens=2, temperature=0.0))
    logits, rows, entries = {}, {}, []
    real_forward, real_execute = engine.executor._forward, engine.execute_model

    def execute(batch):
        entries[:] = [(tuple(e.seq.token_ids[: e.seq.num_prompt_tokens]), e.needs_sample) for e in batch.entries]
        if replaying:
            seen, theirs = step_history(batch), history.pop(0)
            same[:] = [mine == other for mine, other in zip(seen, theirs) for _ in range(mine[1])]
        elif recording:
            history.append(step_history(batch))
        return real_execute(batch)

    def forward(mi, decode_only):
        out = real_forward(mi, decode_only)
        key = "decode" if decode_only else "prefill"
        n = int(mi.num_seqs[0])
        if key not in logits:
            logits[key] = (out[:n].float().cpu(), mi.token_ids[:n].cpu() if decode_only else None)
        for (prompt, samples), row in zip(entries, out[:n].float().cpu()):
            if samples:
                rows.setdefault(prompt, []).append(row)
        return out

    engine.execute_model = execute
    engine.executor._forward = forward
    checks, same = [], []
    recording = replaying = False
    if routes is not None and model.args.n_experts:
        real_router = model._router
        if tp > 1:
            recording = True
            model._router = lambda x, w: routes.append(real_router(x, w)) or routes[-1]
        else:
            replaying = True

            def replay(x, w):
                replayed = routes.pop(0)
                rows = torch.zeros(x.shape[0], dtype=torch.bool)
                rows[: len(same)] = torch.tensor(same, dtype=torch.bool)
                checks.append(route_gaps(x, w, real_router(x, w)[1], replayed[1], rows.to(x.device)))
                return replayed

            model._router = replay
    counters = all_counters()
    steps_log, _, starts, _ = watch_steps(engine, counters)
    ids = record_outputs(llm)
    rank_launches(engine, reset=True)
    ps = prompts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    outs = llm.generate(ps, SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ranks = rank_launches(engine)
    routing = None
    if checks:
        routing = dict(choices=int(sum(n.item() for n, _, _ in checks)),
                       differing=int(sum(c.item() for _, c, _ in checks)),
                       largest_gap=max(g.item() for _, _, g in checks))
    for obj, name in ((engine.executor, "_forward"), (engine, "execute_model"), (model, "_router")):
        obj.__dict__.pop(name, None)
    name = f"{tag}_tp{tp}"
    if len(outs) != len(ps) or not all(o.finished and o.status.ok and o.usage.num_generated_tokens == 32
                                       for o in outs):
        fail(f"{name}: a request did not finish with 32 tokens")
    names = [c.__name__ for c in counters]
    for T, S, decode_only, runs, *got in steps_log:
        want = moe_step_launches(model, T, S, decode_only)
        expected = [runs * want.get(k, 0) for k in names]
        if got != expected:
            fail(f"{name}: a step of T={T}, S={S}, decode_only={decode_only} launched {dict(zip(names, got))} on "
                 f"rank 0, expected {dict(zip(names, expected))}")
    driver = {k: sum(st[4 + i] for st in steps_log) for i, k in enumerate(names)}
    for r, counts in enumerate(ranks):
        if any(counts.get(k, 0) != v for k, v in driver.items()):
            fail(f"{name}: rank {r} launched {counts}, rank 0's steps {driver}")
    spans = [(b - a) * 1e3 for a, b in zip(starts, starts[1:] + [t0 + wall])]
    decode_ms = [ms for ms, st in zip(spans, steps_log) if st[2]]
    del steps_log[:]
    unwatch_steps(engine)
    llm._handler.scheduler.__dict__.pop("_finish_request", None)

    real_execute = engine.execute_model

    def traced(batch):
        with torch.profiler.record_function("tp_step_decode" if batch.is_decode_only else "tp_step_other"):
            return real_execute(batch)

    engine.execute_model = traced
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        llm.generate(prompts(SEED + 1)[:2], SamplingParams(max_tokens=16, temperature=0.0, ignore_eos=True))
        torch.cuda.synchronize()
    engine.__dict__.pop("execute_model", None)
    share = collective_share(prof)
    del prof
    mesh = getattr(engine, "mesh", None)
    figures = dict(tp=tp, sequence_parallel=sp, backend=mesh.backend if tp > 1 else "none",
                   routings=len(routes) if routes is not None and tp > 1 and model.args.n_experts else 0,
                   world_size=mesh.world_size if mesh is not None else 1, load_s=t_load, wall_s=wall,
                   output_tok_per_s=32 * len(ps) / wall, kv_blocks=engine.block_manager.options.num_blocks,
                   unprofiled_decode_step_ms=statistics.median(decode_ms) if decode_ms else None,
                   **{f"profiled_{k}" if k == "decode_step_ms" else k: v for k, v in share.items()})
    emit(dict(phase=name, **figures, own_router=routing, rank_launches=ranks, card=card["nvidia_smi"]))
    return llm, dict(ids=ids, logits=logits, rows=rows, ranks=ranks, driver=driver, figures=figures,
                     own_router=routing)


def tp_compare(torch, card, tag, one, two, exact=False):
    """Hold a tp 2 serve (`two`) to a serve of the same traffic (`one`: tp
    1, or tp 2 without sequence parallelism): the same generated ids,
    request by request, or, where a request's ids differ, `two`'s token at
    the first differing position within LOGITS_TOL of the largest logit of
    `one`'s own logits there (up to that position both serves fed the
    request the same tokens: a near tie that the ranks' f32 sums in another
    order can flip); the first step's logits, and the first decode-only
    step's on its rows whose input token agrees, within LOGITS_TOL (the
    same rounding of different f32 sums through every layer). Where `one`
    replayed `two`'s routing, every replayed choice its own router would
    not have made within LOGITS_TOL of its router's cutoff. `exact`: the
    same ids and logits, bit for bit (two serves whose sums are the same).
    Emits `{tag}_compare`."""
    differing, gaps = [], []
    for p, (prompt_ids, gen) in one["ids"].items():
        got = two["ids"][p][1]
        if got != gen:
            differing.append(p)
            j = next(i for i, (a, b) in enumerate(zip(gen, got)) if a != b)
            row = one["rows"][tuple(prompt_ids)][j]
            gaps.append((row.max() - row[got[j]]).item())
    errs, rows = {}, {}
    for step in ("prefill", "decode"):
        (a, ta), (b, tb) = one["logits"][step], two["logits"][step]
        keep = torch.ones(a.shape[0], dtype=torch.bool) if ta is None else ta == tb
        rows[step] = int(keep.sum())
        errs[step] = (a[keep] - b[keep]).abs().max().item() if rows[step] else 0.0
    line = dict(phase=f"{tag}_compare", requests=len(one["ids"]), differing_requests=len(differing),
                routing_pinned=bool(two["figures"].get("routings")), own_router=one["own_router"],
                largest_gap=max(gaps) if gaps else 0.0, prefill_logits_err=errs["prefill"],
                decode_logits_err=errs["decode"], decode_rows=rows["decode"], tol=0.0 if exact else LOGITS_TOL,
                one=one["figures"], two=two["figures"], card=card["nvidia_smi"])
    emit(line)
    if exact and (differing or errs["prefill"] or errs["decode"]):
        fail(f"{tag}: {len(differing)} requests' ids differ and the logits by {errs}, where they must be the same bits")
    if line["routing_pinned"] and not one["own_router"]:
        fail(f"{tag}: the routing was replayed and not held to the serve's own router")
    if one["own_router"] and not one["own_router"]["choices"]:
        fail(f"{tag}: the tp 1 router was held to the replayed routing on no row")
    if one["own_router"] and one["own_router"]["largest_gap"] > LOGITS_TOL:
        fail(f"{tag}: {one['own_router']['differing']} replayed routing choices differ from the tp 1 router's, "
             f"one by {one['own_router']['largest_gap']} > {LOGITS_TOL} below its cutoff")
    if any(g > LOGITS_TOL for g in gaps):
        fail(f"{tag}: tp 2's ids differ from tp 1's past a near tie (gap {max(gaps)} > {LOGITS_TOL})")
    if not (errs["prefill"] <= LOGITS_TOL and errs["decode"] <= LOGITS_TOL) or not rows["decode"]:
        fail(f"{tag}: tp 2's logits differ from tp 1's by {errs} (tol {LOGITS_TOL}, {rows['decode']} decode rows)")
    return line


def tp_phase(torch, card, tag, path, must_launch, sps=(False,), **kw):
    """One sub-phase of phase 23: a tp 2 serve for each sequence-parallel
    setting of `sps`, each closed (its followers joined) before the next,
    then the tp 1 serve of the same checkpoint and traffic (an MoE model's
    routing replayed from the first tp 2 serve), each tp 2 serve held to it
    (tp_compare, `{tag}[_sp]_tp_compare`) and, with both settings, the SP
    serve held to the one without bit for bit (`{tag}_sp_over_tp2_compare`:
    the same ranks, products and two-rank sums, with the norms and residual
    adds run row by row, so a difference there is SP's fault); each rank must have
    launched every wrapper of `must_launch`. Returns the tp 2 serves'
    driver launches, summed."""
    routes, history, twos, launches = [], [], {}, {}
    for sp in sps:
        name = f"{tag}_sp" if sp else tag
        two_llm, two = tp_serve(torch, card, name, path, 2, sp, *((routes, history) if not twos else ()), **kw)
        try:
            for r, counts in enumerate(two["ranks"]):
                missing = [k for k in must_launch if not counts.get(k, 0) > 0]
                if missing:
                    fail(f"{name}: rank {r} of tp 2 never launched {missing}")
        finally:
            close_llm(torch, card, f"{name}_tp2", two_llm)
        twos[sp] = two
        for k, v in two["driver"].items():
            launches[k] = launches.get(k, 0) + v
    one_llm, one = tp_serve(torch, card, tag, path, 1, routes=routes, history=history, **kw)
    close_llm(torch, card, f"{tag}_tp1", one_llm)
    if routes or (one["own_router"] and history):
        fail(f"{tag}: the tp 1 serve replayed {len(routes)} routings and {len(history)} steps fewer than the "
             "tp 2 serve recorded")
    for sp, two in twos.items():
        tp_compare(torch, card, f"{tag}_sp_tp" if sp else f"{tag}_tp", one, two)
    if len(twos) == 2:
        tp_compare(torch, card, f"{tag}_sp_over_tp2", twos[False], twos[True], exact=True)
    return launches


def phase_tp_dense(torch, card, int4_path):
    """Phase 23 (a) and (b): INT4 Llama-3.1-8B on phase 5's GPTQ checkpoint
    (`int4_path`, phase 5's depth) at tp 2 against tp 1, each rank running
    K1, K2, K4 and K5 at its shapes (16 q heads over 4 KV heads, qkv N 3072,
    gate_up N 14336, down K 7168); TinyLlama-1.1B at full width and depth,
    bf16, tp 2 with sequence parallelism against tp 1; then (e): a line that
    says whether NCCL ran (it needs a card a rank). Returns the launches of
    the tp 2 serves on the driver."""
    launches = tp_phase(torch, card, "tp_int4", int4_path, (
        "ragged_paged_attention_cuda", "quant_matmul_w4a8_cuda", "quant_matmul_dequant_cuda", "rms_prologue"),
        quantize_lm_head=True)
    tmp = tempfile.mkdtemp(prefix="scalellm_tp_tinyllama_")
    try:
        write_checkpoint(torch, tmp, TINYLLAMA)
        for k, v in tp_phase(torch, card, "tp_tinyllama", tmp, ("ragged_paged_attention_cuda",),
                             sps=(False, True)).items():
            launches[k] = launches.get(k, 0) + v
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cards = torch.cuda.device_count()
    emit(dict(phase="tp_nccl", ran=False, cards=cards, card=card["nvidia_smi"],
              note="NCCL needs a card a rank; one card is visible, so the NCCL path (the same code with "
                   "backend nccl) did not run" if cards < 2 else "more than one card is visible"))
    if cards > 1:
        tp_nccl(torch, card, int4_path)
    return launches


def tp_nccl(torch, card, int4_path):
    """Phase 23 (e) where the machine has two cards: (a)'s serve over NCCL,
    one card a rank, against tp 1."""
    global TP_DEVICES
    saved, TP_DEVICES = TP_DEVICES, "cuda:0,cuda:1"
    try:
        tp_phase(torch, card, "tp_int4_nccl", int4_path, (
            "ragged_paged_attention_cuda", "quant_matmul_w4a8_cuda", "quant_matmul_dequant_cuda"),
            quantize_lm_head=True)
    finally:
        TP_DEVICES = saved


def phase_tp_moe(torch, card, path):
    """Phase 23 (c) and (d), on phase 8's Mixtral checkpoint while it
    exists: bf16 at tp 2, 4 experts a rank (K6 on each rank), against tp 1;
    then moe_mlp_a2a across two ranks (phase_tp_a2a). Returns the tp 2
    serve's driver launches."""
    launches = tp_phase(torch, card, "tp_mixtral", path, ("ragged_paged_attention_cuda", "grouped_matmul_cuda"))
    phase_tp_a2a(torch, card)
    return launches


# ------------------------------------------------------------------ main


def kernel_entry(name, source, replaces, launches, cases, main_case):
    """One entry of the `kernels` line: the timing of the main path's shape,
    the largest error over every checked shape."""
    r = cases[main_case]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    }


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--int4-layers", type=int, default=INT4_LAYERS,
                        help="depth of the INT4 Llama-3.1-8B run (of 32; its widths are never cut)")
    parser.add_argument("--deepseek-layers", type=int, default=DEEPSEEK_LAYERS,
                        help="depth of the DeepSeek-V2-Lite runs, bf16 and INT4 (of 27; their widths are never cut)")
    parser.add_argument("--mixtral-layers", type=int, default=MIXTRAL_LAYERS,
                        help="depth of the Mixtral-8x7B runs, bf16 and INT4 (of 32; their widths are never cut)")
    parser.add_argument("--gemma2-layers", type=int, default=GEMMA2_LAYERS,
                        help="depth of the Gemma-2-9B runs, bf16 and INT4 (of 42; even, so that sliding and "
                             "global layers both run; the widths are never cut)")
    parser.add_argument("--qwen3-layers", type=int, default=QWEN3_LAYERS,
                        help="depth of the Qwen3-8B runs, bf16 and INT4 (of 36; the widths are never cut)")
    parser.add_argument("--phi2-layers", type=int, default=PHI2_LAYERS,
                        help="depth of the Phi-2 runs, bf16 and INT4 (of 32; the widths are never cut)")
    parser.add_argument("--mpt-layers", type=int, default=MPT_LAYERS,
                        help="depth of the MPT-7B runs, bf16 and INT4 (of 32; the widths are never cut)")
    opts = parser.parse_args()
    if opts.gemma2_layers % 2:
        parser.error("--gemma2-layers must be even: Gemma2 alternates sliding and global layers")

    t_start = time.monotonic()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scalellm_tpu_torch  # noqa: F401  (fails where the repository is missing)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_seconds = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        phase_seconds[name] = time.monotonic() - t0
        return out

    card = phase_device(torch)
    timed("build", phase_build)
    attention_results = timed("3a", phase_kernels, torch, card)
    quant_results = timed("3b", phase_quant_kernels, torch, card)
    gmm_results, mla_results = timed("3c", phase_moe_mla_kernels, torch, card)
    dequant_results = timed("3c_dequant", phase_expert_dequant, torch, card)
    moe_quant_results = timed("3d", phase_moe_quant_kernels, torch, card)
    small_m_results, mlp_launches = timed("3e", phase_small_m_kernels, torch, card)
    count_captured_launches()
    bf16_launches, bf16_blocks = timed("4", phase_end_to_end, torch, card)
    # Phase 5's checkpoint is kept for phase 23 (a).
    int4_launches, int4_path = timed("5", phase_end_to_end_int4, torch, card, opts.int4_layers, True)
    # From here to phase 23 (a), which reads it, phase 5's checkpoint stays on disk.
    try:
        # Phases 6-15: each checkpoint written once, served in bf16 and then
        # with runtime INT4 (phases 14 and 15: bf16 and f32 alone), and removed.
        moe_launches, tp_launches = {}, {}
        both = ("", "int4")
        for phase, name, base, tensors_of, flag, layers, serves, quantizes in (
                ("6-7", "deepseek", DEEPSEEK_V2_LITE, deepseek_checkpoint_tensors, "--deepseek-layers",
                 opts.deepseek_layers, SERVES, both),
                ("8", "mixtral", MIXTRAL_8X7B, mixtral_checkpoint_tensors, "--mixtral-layers", opts.mixtral_layers,
                 MOE_SERVES, both),
                ("9", "qwen2_moe", QWEN15_MOE_A27B, qwen2_moe_checkpoint_tensors, None,
                 QWEN15_MOE_A27B["num_hidden_layers"], MOE_SERVES, both),
                ("10", "gemma2", GEMMA2_9B, gemma2_checkpoint_tensors, "--gemma2-layers", opts.gemma2_layers,
                 MOE_SERVES, both),
                ("11", "qwen3", QWEN3_8B, qwen3_checkpoint_tensors, "--qwen3-layers", opts.qwen3_layers, MOE_SERVES,
                 both),
                ("12", "phi2", PHI2, phi_checkpoint_tensors, "--phi2-layers", opts.phi2_layers, MOE_SERVES, both),
                ("13", "mpt7b", MPT_7B, mpt_checkpoint_tensors, "--mpt-layers", opts.mpt_layers, MOE_SERVES, both),
                ("14", "bloom560m", BLOOM_560M, bloom_checkpoint_tensors, None, layers_of(BLOOM_560M), MOE_SERVES,
                 ("",)),
                ("15", "gpt2", GPT2, gpt2_checkpoint_tensors, None, layers_of(GPT2), MOE_SERVES, ("",))):
            t0 = time.monotonic()
            cfg = with_layers(base, layers)
            path, nbytes, t_write = write_temp_checkpoint(torch, name, cfg, tensors_of(cfg), flag,
                                                          None if phase in ("6-7", "8", "9") else scaled_init(cfg))
            try:
                emit(dict(phase=f"{name}_checkpoint", layers=layers, checkpoint_bytes=nbytes, write_s=t_write))
                for quantize in quantizes:
                    moe_launches[(name, quantize)] = phase_end_to_end_moe(
                        torch, card, name, path, layers, layers_of(base), nbytes, quantize, serves)
                if name == "mixtral":
                    # Phase 23 (c) and (d): tensor parallelism on the same checkpoint.
                    t23 = time.monotonic()
                    tp_launches["mixtral"] = phase_tp_moe(torch, card, path)
                    phase_seconds["23cd"] = time.monotonic() - t23
                    t0 += phase_seconds["23cd"]
                if name == "deepseek":
                    # Phase 17: the same checkpoint over int8 latent pages.
                    t17 = time.monotonic()
                    moe_launches[(name, "int8kv")] = phase_end_to_end_moe(
                        torch, card, name, path, layers, layers_of(base), nbytes, "", MOE_SERVES, kv_cache_dtype="int8")
                    phase_seconds["17"] = time.monotonic() - t17
                    t0 += phase_seconds["17"]
            finally:
                shutil.rmtree(path, ignore_errors=True)
            phase_seconds[phase] = time.monotonic() - t0
        for phases, names, wrappers in (
                ("8 and 9", ("mixtral", "qwen2_moe"), (
                    "ragged_paged_attention_cuda", "quant_matmul_w4a8_cuda", "quant_matmul_dequant_cuda",
                    "grouped_matmul_cuda", "expert_dequant_cuda", "grouped_quant_matmul_cuda",
                    "grouped_quant_matmul_pair_cuda")),
                ("10 and 11", ("gemma2", "qwen3"), (
                    "ragged_paged_attention_cuda", "quant_matmul_w4a8_cuda", "quant_matmul_dequant_cuda")),
                ("12-15", ("phi2", "mpt7b", "bloom560m", "gpt2"), (
                    "ragged_paged_attention_alibi", "ragged_paged_attention_d80", "ragged_paged_attention_f32",
                    "quant_matmul_w4a8_cuda", "quant_matmul_dequant_cuda"))):
            runs = [run for (name, _), run in moe_launches.items() if name in names]
            for wrapper in wrappers:
                if not sum(run.get(wrapper, 0) for run in runs) > 0:
                    fail(f"phases {phases} never launched {wrapper}")
        for model, run in timed("16", phase_kv_int8, torch, card, bf16_blocks).items():
            moe_launches[(model, "int8kv")] = run
        timed("18", phase_kv_swap, torch, card)
        spec_k1 = timed("19", phase_speculative, torch, card)
        lora_launches = timed("20", phase_lora, torch, card, opts.int4_layers)
        guided_k1 = timed("21", phase_guided, torch, card)
        serve_k1 = timed("22", phase_servers, torch, card)
        tp_launches["dense"] = timed("23abe", phase_tp_dense, torch, card, int4_path)
    finally:
        shutil.rmtree(int4_path, ignore_errors=True)
    new_k1 = (sum(run.get("ragged_paged_attention_cuda", 0) for run in (*moe_launches.values(), *tp_launches.values()))
              + spec_k1 + lora_launches.get("ragged_paged_attention_cuda", 0) + guided_k1 + serve_k1)

    # Each kernel's launches on the main paths (the sync, async and ms4
    # serves with graphs; K1's f32 kernel apart from the bf16 one: counts set to 0 before each timed generate and
    # read after it, with each replayed step graph adding what its wrappers
    # counted when it was captured; the checks above, and the eager serves
    # beside the graph ones, launch outside that window; phase 5's variant
    # serves run on its eager engine; phase 19's K1 launches those of its
    # draft-model and n-gram serves with graphs, each round's as its graph
    # counted at its capture; phase 20's those of its LoRA serves with
    # graphs: TinyLlama's sync, async and ms4, INT4's sync; phase 21's those
    # of its guided and unconstrained serves with graphs and of its
    # AsyncLLMEngine serve; phase 22's those of its two passes through the
    # HTTP server, its gRPC pass and its gateway request; phase 23's those
    # of rank 0 in its tp 2 serves, each rank's read back and held equal),
    # summed over the paths
    # that run it, and its timing at a shape the main
    # path gives it: attention at the 8-sequence decode batch, w4a8 at the
    # decode step's gate_up projection (T = 16), dequant and group at the
    # 512-token step's; the grouped GEMM at the decode step's gate/up (96
    # rows, padding included), the int4 expert dequantization at gate/up (as
    # phase 7's prefill steps run it before K6), the MLA decode kernel at the 8-sequence decode
    # batch, the MLA prefill kernel at the mixed T = 512 batch; K8 and K7 at
    # the INT4 decode step (96 rows) of gate/up and down; gemv, w4a8g and
    # the stream probe at the decode step's gate_up projection (T = 16; the
    # probe's launches are those of phase 5's in-model probe step); K11 at
    # the 8B MLP, M = 16, launched by its own path (its entry point at M =
    # 1, 8, 16, 32, 64: no model calls it).
    def launched(name):
        return sum(run.get(name, 0) for run in (int4_launches, lora_launches, *moe_launches.values(),
                                                 *tp_launches.values()))

    source = "scalellm_tpu_torch/csrc/quant_matmul.cu"
    moe_source = "scalellm_tpu_torch/csrc/moe_quant.cu"
    gemv_source = "scalellm_tpu_torch/csrc/quant_gemv.cu"
    # K1's launches by kernel and page type: every f32 launch of an int8-KV
    # run is on int8 pages.
    f32_k1 = launched("ragged_paged_attention_f32")
    int8_k1 = launched("ragged_paged_attention_int8")
    f32_int8_k1 = sum(run.get("ragged_paged_attention_f32", 0) for (_, v), run in moe_launches.items()
                      if v == "int8kv")

    def k1_shapes(f32, int8):
        return {n: r for n, r in attention_results.items()
                if (ATTENTION_SHAPES[n].get("dtype") == "float32") == f32 and ATTENTION_SHAPES[n].get("kv_int8",
                                                                                                       False) == int8}

    k1_source, k1_replaces = "scalellm_tpu_torch/csrc/ragged_paged_attention.cu", "scalellm_tpu/ops/attention.py:132"
    f32_source = "scalellm_tpu_torch/csrc/ragged_paged_attention_f32.cu"
    mla_source = "scalellm_tpu_torch/csrc/mla_attention.cu"
    kernels = [
        kernel_entry("ragged_paged_attention", k1_source, k1_replaces,
                     bf16_launches + int4_launches["ragged_paged_attention_cuda"] + new_k1 - f32_k1
                     - (int8_k1 - f32_int8_k1), k1_shapes(False, False), "a_decode"),
        kernel_entry("ragged_paged_attention_int8", k1_source, k1_replaces, int8_k1 - f32_int8_k1,
                     k1_shapes(False, True), "t_decode_int8_llama8b"),
        kernel_entry("ragged_paged_attention_f32", f32_source, k1_replaces, f32_k1 - f32_int8_k1,
                     k1_shapes(True, False), "r_decode_f32_gpt2"),
        kernel_entry("ragged_paged_attention_f32_int8", f32_source, k1_replaces, f32_int8_k1,
                     k1_shapes(True, True), "w_decode_int8_f32_gpt2"),
        kernel_entry("quant_matmul_w4a8", source, "scalellm_tpu/ops/quant_matmul.py:360",
                     launched("quant_matmul_w4a8_cuda"), quant_results["w4a8"],
                     ("gate_up_proj", 16, False)),
        kernel_entry("quant_matmul_group", source, "scalellm_tpu/ops/quant_matmul.py:259",
                     launched("quant_matmul_group_cuda"), quant_results["group"],
                     ("gate_up_proj", 512, False)),
        kernel_entry("quant_matmul_dequant", source, "scalellm_tpu/ops/quant_matmul.py:519",
                     launched("quant_matmul_dequant_cuda"), quant_results["dequant"],
                     ("gate_up_proj", 512, False)),
        kernel_entry("grouped_matmul", "scalellm_tpu_torch/csrc/grouped_matmul.cu",
                     "scalellm_tpu/layers/moe.py:70", launched("grouped_matmul_cuda"),
                     gmm_results, ("v2_lite", "decode", "gate_up")),
        kernel_entry("expert_dequant", "scalellm_tpu_torch/csrc/expert_dequant.cu",
                     "scalellm_tpu/ops/moe_quant.py:633", launched("expert_dequant_cuda"), dequant_results,
                     "gate_up"),
        kernel_entry("moe_quant_decode", moe_source, "scalellm_tpu/ops/moe_quant.py:541",
                     launched("grouped_quant_matmul_cuda"),
                     {c: r for c, r in moe_quant_results.items() if c[0] == "down"}, ("down", 4, "decode")),
        kernel_entry("moe_quant_decode_pair", moe_source, "scalellm_tpu/ops/moe_quant.py:406",
                     launched("grouped_quant_matmul_pair_cuda"),
                     {c: r for c, r in moe_quant_results.items() if c[0] == "gate_up"},
                     ("gate_up", 4, "decode")),
        kernel_entry("mla_decode", mla_source, "scalellm_tpu/ops/mla_attention.py:96",
                     launched("mla_decode_attention_cuda") - launched("mla_decode_attention_int8"),
                     mla_results["mla_decode"], "decode"),
        kernel_entry("mla_decode_int8", mla_source, "scalellm_tpu/ops/mla_attention.py:96",
                     launched("mla_decode_attention_int8"), mla_results["mla_decode_int8"], "decode_int8"),
        kernel_entry("mla_prefill", mla_source, "scalellm_tpu/ops/mla_attention.py:271",
                     launched("mla_prefill_attention_cuda") - launched("mla_prefill_attention_int8"),
                     mla_results["mla_prefill"], "mixed"),
        kernel_entry("mla_prefill_int8", mla_source, "scalellm_tpu/ops/mla_attention.py:271",
                     launched("mla_prefill_attention_int8"), mla_results["mla_prefill_int8"], "mixed_int8"),
        kernel_entry("quant_gemv", gemv_source, "scalellm_tpu/ops/quant_matmul.py:304",
                     launched("quant_gemv_cuda"), small_m_results["gemv"], ("gate_up_proj", 16)),
        kernel_entry("quant_w4a8_gemv", gemv_source, "scalellm_tpu/ops/quant_matmul.py:466",
                     launched("quant_w4a8_gemv_cuda"), small_m_results["w4a8g"], ("gate_up_proj", 16)),
        kernel_entry("quant_stream_probe", gemv_source, "scalellm_tpu/ops/quant_matmul.py:556",
                     launched("quant_stream_probe_cuda"), small_m_results["stream"], ("gate_up_proj", 16)),
        kernel_entry("quant_mlp", "scalellm_tpu_torch/csrc/quant_mlp.cu", "scalellm_tpu/ops/quant_mlp.py:78",
                     mlp_launches, small_m_results["mlp"], ("llama8b_mlp", 16)),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"the main paths never launched {k['name']}")
    emit(dict(phase="elapsed", seconds=time.monotonic() - t_start, by_phase=phase_seconds))
    emit({"kernels": kernels})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
