"""The port's kernels: each CUDA kernel's wrapper counts its launches in
`launches` (on the CUDA path only), some of them also kinds of launch in
sub-counts (attention.LaunchCount)."""


def kernel_counters() -> dict:
    """Every kernel wrapper's count and sub-count, by name; each has
    `launches`, which may be read and reset."""
    from scalellm_tpu_torch.ops import attention, grouped_matmul, mla_attention, moe_quant, quant_matmul, quant_mlp

    k1, Q, M = attention.ragged_paged_attention_cuda, quant_matmul, mla_attention
    counters = (
        k1, k1.alibi, k1.d80, k1.f32, k1.int8,
        Q.quant_matmul_w4a8_cuda, Q.quant_matmul_w4a8_cuda.prologue,
        Q.quant_matmul_group_cuda, Q.quant_matmul_group_cuda.prologue,
        Q.quant_matmul_dequant_cuda, Q.quant_matmul_dequant_cuda.prologue,
        Q.quant_gemv_cuda, Q.quant_w4a8_gemv_cuda, Q.quant_stream_probe_cuda, quant_mlp.quant_mlp_cuda,
        grouped_matmul.grouped_matmul_cuda, moe_quant.grouped_quant_matmul_cuda,
        moe_quant.grouped_quant_matmul_pair_cuda, moe_quant.expert_dequant_cuda,
        M.mla_decode_attention_cuda, M.mla_decode_attention_cuda.int8,
        M.mla_prefill_attention_cuda, M.mla_prefill_attention_cuda.int8,
    )
    return {c.__name__: c for c in counters}
