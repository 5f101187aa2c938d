#!/usr/bin/env python3
"""On-card smoke test of scalellm_tpu_torch, the PyTorch/CUDA port.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
  2. build: every CUDA kernel of the serving path, from csrc/ with nvcc.
  3. kernels: the ragged paged attention kernel against its plain PyTorch
     version in bf16 at four shapes of the serving path, with CUDA-event
     timings of the kernel, the plain version and a library yardstick
     (scaled_dot_product_attention on gathered contiguous K/V), beside the
     least time the card could take (bytes over 3.35 TB/s, flops over
     989 TFLOP/s bf16).
  4. end to end: a TinyLlama-1.1B-shaped bf16 checkpoint (random weights
     from a seed) served by scalellm_tpu_torch.LLM with chunked prefill and
     the prefix cache; every request must finish and every engine step must
     go through the kernel. Then one prefill batch runs through the model
     twice, with the kernel and with the plain attention, and the logits
     must agree.
  5. a `kernels` JSON line, then the result line.

It needs the repository (it fails in a directory that holds only this
script) and a CUDA device (it fails where torch.cuda.is_available() is
false). JSON lines carry the numbers; the card's name and power limit stand
beside every timing.
"""

from __future__ import annotations

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
KERNEL_TOL = 2e-2  # bf16 output (8-bit mantissa) of values of magnitude <~ 3
# Logits of the 22-layer random-weight model (std ~1): the two attentions
# round different f32 sums to bf16, and those 1-ulp differences pass through
# 22 bf16 layers.
LOGITS_TOL = 0.25
TIMED_RUNS = 20
SEED = 0
DEVICE = "cuda"

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


def make_batch(torch, gen, *, q_lens, kv_lens, S, T, H, Hkv, D, page=16):
    """Inputs of ragged paged attention on the card. Sequence i has a chunk
    of q_lens[i] tokens at the tail of kv_lens[i]; slots past len(q_lens)
    are padding sequences; rows past sum(q_lens) are bucket padding; pages
    are distinct and never page 0."""
    dev = DEVICE
    n_real = len(q_lens)
    maxp_real = max(-(-k // page) for k in kv_lens)
    maxp = next(b for b in (4, 16, 64, 256, 1024) if b >= maxp_real)
    n_pages = 1 + sum(-(-k // page) for k in kv_lens)
    q = torch.randn(T, H, D, generator=gen, device=dev).to(torch.bfloat16)
    kv_pages = torch.randn(n_pages, page, 2 * Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
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
    """Least time on the card: each input byte read once, each output byte
    written once, and the flops this batch's masks need."""
    H, Hkv, D = spec["H"], spec["Hkv"], spec["D"]
    tok, seq = kv_ranges(spec["q_lens"], spec["kv_lens"], spec["window"])
    kv_bytes = sum(e - b for b, e in seq) * Hkv * 2 * D * 2
    q_bytes = inputs["q"].numel() * 2
    index_bytes = sum(inputs[k].numel() * 4 for k in ("kv_lens", "page_indices", "cu_q_lens", "num_seqs"))
    nbytes = kv_bytes + 2 * q_bytes + index_bytes  # q in, out written
    flops = sum(e - b for b, e in tok) * H * D * 4  # q.k and p.v, multiply-add
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_flops), ("bytes" if t_bytes >= t_flops else "operations"), nbytes, flops


def sdpa_inputs(torch, spec, inputs):
    """q, K, V gathered per sequence into padded contiguous tensors with
    K/V heads repeated to the q heads, and the boolean mask of causal,
    window and length masking."""
    H, Hkv, D = spec["H"], spec["Hkv"], spec["D"]
    q_lens, kv_lens, window = spec["q_lens"], spec["kv_lens"], spec["window"]
    S, qmax, lmax = len(q_lens), max(q_lens), max(kv_lens)
    page = inputs["kv_pages"].shape[1]
    qs = torch.zeros(S, H, qmax, inputs["q"].shape[2], dtype=torch.bfloat16, device=DEVICE)
    ks = torch.zeros(S, Hkv, lmax, D, dtype=torch.bfloat16, device=DEVICE)
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
    return qs, ks.repeat_interleave(rep, 1).contiguous(), vs.repeat_interleave(rep, 1).contiguous(), mask


def time_ms(torch, fn, flush):
    """Median over TIMED_RUNS of one call, timed with CUDA events, with the
    L2 cache flushed before each call (the engine reads each layer's KV
    cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(torch, card):
    import torch.nn.functional as F

    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention as plain

    kernel = attention.ragged_paged_attention_cuda
    decode_kv = [17, 64, 129, 256, 400, 640, 900, 1024]
    specs = {
        # 8 decodes, TinyLlama heads, bucket-padded to T=16, S=8.
        "a_decode": dict(q_lens=[1] * 8, kv_lens=decode_kv, S=8, T=16, H=32, Hkv=4, D=64, window=None, cap=None),
        # Two prefill chunks (one the tail of a longer context) and six
        # decodes, padded to T=512 as the token ladder pads 456 tokens.
        "b_mixed": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                        S=8, T=512, H=32, Hkv=4, D=64, window=None, cap=None),
        # Head dim 128 with 32:8 GQA (Llama-3-8B heads), decode.
        "c_d128_gqa4": dict(q_lens=[1] * 8, kv_lens=decode_kv, S=8, T=16, H=32, Hkv=8, D=128, window=None, cap=None),
        # A sliding window plus a logit soft cap on the mixed batch.
        "d_window_softcap": dict(q_lens=[200, 250, 1, 1, 1, 1, 1, 1], kv_lens=[200, 300, 17, 64, 256, 512, 900, 1024],
                                 S=8, T=512, H=32, Hkv=4, D=64, window=128, cap=50.0),
    }
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEVICE)  # > 50 MB L2
    results = {}
    for name, spec in specs.items():
        inputs = make_batch(torch, gen, q_lens=spec["q_lens"], kv_lens=spec["kv_lens"], S=spec["S"],
                            T=spec["T"], H=spec["H"], Hkv=spec["Hkv"], D=spec["D"])
        kw = dict(sm_scale=spec["D"] ** -0.5, sliding_window=spec["window"], logit_soft_cap=spec["cap"])
        got = kernel(**inputs, **kw)
        torch.cuda.synchronize()
        want = plain(**inputs, **kw)
        n_real = sum(spec["q_lens"])
        if not torch.isfinite(got).all():
            fail(f"{name}: kernel output is not finite")
        if not torch.all(got[n_real:] == 0):
            fail(f"{name}: padding rows are not zero")
        err = (got.float() - want.float()).abs().max().item()
        if not err <= KERNEL_TOL:
            fail(f"{name}: kernel differs from the plain version by {err} > {KERNEL_TOL}")
        ms = time_ms(torch, lambda: kernel(**inputs, **kw), flush)
        plain_ms = time_ms(torch, lambda: plain(**inputs, **kw), flush)
        library_ms = None
        if spec["cap"] is None:  # SDPA has no soft cap: no library call computes (d)
            qs, ks, vs, mask = sdpa_inputs(torch, spec, inputs)
            library_ms = time_ms(
                torch, lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, scale=kw["sm_scale"]),
                flush)
        bound_ms, bound_by, nbytes, flops = bound(spec, inputs)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=library_ms)
        emit(dict(phase="kernel", kernel="ragged_paged_attention", shape=name, tol=KERNEL_TOL,
                  T=spec["T"], S=spec["S"], real_tokens=n_real, H=spec["H"], Hkv=spec["Hkv"], D=spec["D"],
                  window=spec["window"], soft_cap=spec["cap"], bytes=nbytes, flops=flops,
                  **results[name], card=card["nvidia_smi"]))
    return results


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


def write_checkpoint(torch, path, cfg):
    """config.json, tokenizer.json and model.safetensors (bf16, weights
    N(0, 0.02) from a seeded generator, norms 1)."""
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(path, "tokenizer.json"), "w") as f:
        json.dump(char_tokenizer_json(), f)
    tensors = checkpoint_tensors(cfg)
    header, offset = {}, 0
    for name, shape, _ in tensors:
        n = 2
        for d in shape:
            n *= d
        header[name] = {"dtype": "BF16", "shape": list(shape), "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    with open(os.path.join(path, "model.safetensors"), "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, shape, is_norm in tensors:
            if is_norm:
                t = torch.ones(shape, dtype=torch.bfloat16)
            else:
                t = (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16).cpu()
            f.write(t.view(torch.uint8).numpy().tobytes())
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


def prefill_inputs(torch, token_lists, page=16):
    """ModelInputs of one prefill batch of whole prompts, padded to the
    token ladder, each sequence on its own pages (page 0 reserved)."""
    from scalellm_tpu_torch.engine.batch import PAGE_BUCKETS, SEQ_BUCKETS, TOKEN_BUCKETS, pick_bucket
    from scalellm_tpu_torch.engine.params import ModelInputs

    n = [len(t) for t in token_lists]
    T, S = pick_bucket(TOKEN_BUCKETS, sum(n)), pick_bucket(SEQ_BUCKETS, len(n))
    maxp = pick_bucket(PAGE_BUCKETS, max(-(-k // page) for k in n))
    tok = torch.zeros(T, dtype=torch.int32)
    pos = torch.zeros(T, dtype=torch.int32)
    seg = torch.zeros(T, dtype=torch.int32)
    slots = torch.zeros(T, dtype=torch.int32)
    tables = torch.zeros(S, maxp, dtype=torch.int32)
    kv = torch.zeros(S, dtype=torch.int32)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    sel = torch.zeros(S, dtype=torch.int32)
    t, next_page = 0, 1
    for s, ids in enumerate(token_lists):
        k = len(ids)
        pages = torch.arange(next_page, next_page + -(-k // page), dtype=torch.int32)
        next_page += len(pages)
        p = torch.arange(k, dtype=torch.int32)
        tok[t : t + k] = torch.tensor(ids, dtype=torch.int32)
        pos[t : t + k] = p
        seg[t : t + k] = s
        slots[t : t + k] = pages[p // page] * page + p % page
        tables[s, : len(pages)] = pages
        kv[s] = k
        cu[s + 1] = t + k
        sel[s] = t + k - 1
        t += k
    cu[len(n) + 1 :] = cu[len(n)]
    mi = ModelInputs(token_ids=tok, positions=pos, token_seg=seg, new_kv_slot_ids=slots,
                     block_tables=tables, kv_lens=kv, cu_q_lens=cu,
                     num_seqs=torch.tensor([len(n)], dtype=torch.int32), selected_idxes=sel,
                     seq_mask=(torch.arange(S) < len(n)).float())
    return mi, next_page


def device_breakdown(prof, wall_s, steps):
    """Device time by kernel from a profiler trace, in three groups (the
    attention kernel, matrix products, the rest), the kernels launched per
    engine step, and the share of `wall_s` the device was idle. Kernels run
    on one stream, so their times add up to the device's busy time."""
    from torch.autograd import DeviceType

    per_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    groups = dict(attention_ms=0.0, matmul_ms=0.0, other_ms=0.0)
    for name, (ms, _) in per_name.items():
        low = name.lower()
        if "ragged_paged_attention" in low:
            groups["attention_ms"] += ms
        elif any(w in low for w in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
            groups["matmul_ms"] += ms
        else:
            groups["other_ms"] += ms
    busy_ms = sum(groups.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(
        device_busy_ms=busy_ms if per_name else None,
        idle_share=1.0 - busy_ms / (1e3 * wall_s) if per_name else None,
        kernels_per_step=sum(n for _, n in per_name.values()) / steps, **groups,
        top=[dict(name=name[:90], ms=ms, count=n) for name, (ms, n) in top],
    )


def phase_end_to_end(torch, card):
    from scalellm_tpu_torch import LLM, SamplingParams
    from scalellm_tpu_torch.ops import attention
    from scalellm_tpu_torch.ops.attention_ref import ref_ragged_paged_attention
    from scalellm_tpu_torch.utils.metrics import COUNTERS, HISTOGRAMS

    cfg = TINYLLAMA
    L = cfg["num_hidden_layers"]
    tmp = tempfile.mkdtemp(prefix="scalellm_tinyllama_")
    llm = None
    try:
        t0 = time.monotonic()
        nbytes = write_checkpoint(torch, tmp, cfg)
        t_write = time.monotonic() - t0
        t0 = time.monotonic()
        # Defaults (device cuda), with chunked prefill on: a 512-token step
        # budget splits the longer prompts.
        llm = LLM(tmp, max_tokens_per_batch=512)
        torch.cuda.synchronize()
        t_load = time.monotonic() - t0
        engine = llm._handler.engine
        emit(dict(phase="e2e_setup", checkpoint_bytes=nbytes, write_s=t_write, load_s=t_load,
                  kv_blocks=engine.block_manager.options.num_blocks))

        greedy = SamplingParams(max_tokens=32, temperature=0.0, ignore_eos=True)
        llm.generate(["warm up the engine"], SamplingParams(max_tokens=2, temperature=0.0))
        ps = prompts()
        ttft = HISTOGRAMS.get("time_to_first_token_latency_seconds")
        ttft_before = (ttft.total, ttft.count)
        steps_before = COUNTERS.get("num_engine_steps")
        kernel = attention.ragged_paged_attention_cuda
        kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        outs = llm.generate(ps, greedy)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = kernel.launches
        steps = int(COUNTERS.get("num_engine_steps") - steps_before)
        ttft = HISTOGRAMS.get("time_to_first_token_latency_seconds")
        mean_ttft = (ttft.total - ttft_before[0]) / max(ttft.count - ttft_before[1], 1)

        if len(outs) != len(ps):
            fail(f"{len(outs)} of {len(ps)} requests returned")
        # Generated tokens are counted from usage: the char tokenizer names
        # ids below 256 only, and the output's token_ids hold only the ids
        # that decoded to text (the random model mostly picks higher ids).
        for o in outs:
            if not (o.finished and o.status.ok and o.usage.num_generated_tokens == 32):
                fail(f"request did not finish with 32 tokens: {o.status}, {o.usage}")
        if steps <= 0 or launches < L * steps:
            fail(f"kernel launched {launches} times in {steps} engine steps (need >= {L} per step)")
        n_tokens = sum(o.usage.num_generated_tokens for o in outs)
        emit(dict(phase="e2e", requests=len(outs), prompt_chars=[len(p) for p in ps],
                  output_tokens=n_tokens, wall_s=wall, output_tok_per_s=n_tokens / wall,
                  mean_ttft_s=mean_ttft, engine_steps=steps, kernel_launches=launches,
                  launches_per_step=launches / steps, card=card["nvidia_smi"]))

        # Where the device time goes: the same workload (other text, same
        # prompt lengths) once more under torch.profiler. The profiler slows
        # the host, so the idle share is taken against the unprofiled run's
        # wall time above.
        from torch.profiler import ProfilerActivity, profile

        steps_before = COUNTERS.get("num_engine_steps")
        t0 = time.monotonic()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            llm.generate(prompts(SEED + 1), greedy)
            torch.cuda.synchronize()
        profiled_wall = time.monotonic() - t0
        profiled_steps = int(COUNTERS.get("num_engine_steps") - steps_before)
        emit(dict(phase="e2e_profile", engine_steps=profiled_steps, profiled_wall_s=profiled_wall,
                  unprofiled_wall_s=wall, **device_breakdown(prof, wall, profiled_steps),
                  card=card["nvidia_smi"]))

        # One prefill batch through the model twice, over the same weights:
        # the kernel, then the plain attention. The engine's KV cache (most
        # of the card's memory) is freed first, to leave room for the plain
        # version's gathered copies of K and V.
        model = engine.model
        tok = llm._handler.tokenizer
        engine = None
        llm.close()
        llm = None
        torch.cuda.empty_cache()
        mi, n_pages = prefill_inputs(torch, [tok.encode(ps[0])[:200], tok.encode(ps[5])])
        mi = mi.to(DEVICE)
        n_tok = int(mi.cu_q_lens[-1])
        logits = {}
        with torch.inference_mode():
            for impl in ("kernel", "plain"):
                model.attn_impl = (
                    ref_ragged_paged_attention if impl == "plain" else attention.ragged_paged_attention
                )
                kv = torch.zeros(model.kv_cache_shape(n_pages, 16), dtype=model.dtype, device=DEVICE)
                # Logits of every real token of the batch, not only the last.
                logits[impl] = model.logits(model(kv, mi, all_hidden=True)[:n_tok])
                del kv
        model.attn_impl = attention.ragged_paged_attention
        diff = (logits["kernel"] - logits["plain"]).abs()
        err = diff.max().item()
        same_argmax = (logits["kernel"].argmax(-1) == logits["plain"].argmax(-1)).float().mean().item()
        emit(dict(phase="e2e_logits", tokens=n_tok, max_abs_err=err,
                  mean_abs_err=diff.mean().item(), logits_std=logits["plain"].std().item(),
                  argmax_agreement=same_argmax, tol=LOGITS_TOL))
        if not torch.isfinite(logits["kernel"]).all() or not err <= LOGITS_TOL:
            fail(f"kernel logits differ from plain-attention logits by {err} > {LOGITS_TOL}")
        return launches
    finally:
        if llm is not None:
            llm.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------------ main


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scalellm_tpu_torch  # noqa: F401  (fails where the repository is missing)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_device(torch)
    phase_build()
    results = phase_kernels(torch, card)
    launches = phase_end_to_end(torch, card)

    a = results["a_decode"]
    emit({"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "scalellm_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "scalellm_tpu/ops/attention.py:131",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in results.values()),
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": a["library_ms"],
    }]})
    print(card["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
