"""Accuracy evaluation harness (counterpart of scalellm_tpu/eval/):
perplexity scoring (ppl.py) and the int8 KV cache's scale calibration
(kv_calibration.py)."""
