"""Weight-only quantization: AWQ/GPTQ checkpoint formats, the rules that
load them, and runtime quantization of a dense model (counterpart of
scalellm_tpu/quantization/). The matmuls are ops/quant_matmul.py."""
