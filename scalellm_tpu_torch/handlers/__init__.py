from scalellm_tpu_torch.handlers.llm_handler import LLMHandler, LLMHandlerOptions

__all__ = ["LLMHandler", "LLMHandlerOptions"]
