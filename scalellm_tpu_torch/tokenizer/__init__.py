from scalellm_tpu_torch.tokenizer.tokenizer import (
    HFTokenizer,
    WordLevelTokenizer,
    load_tokenizer,
)

__all__ = ["HFTokenizer", "WordLevelTokenizer", "load_tokenizer"]
