"""Model registry: per-model-type factories.

Equivalent of the reference's ModelRegistry
(reference: src/models/model_registry.h:46-194): maps HF model_type to a
causal-LM factory, a ModelArgs loader (from HF config.json), and a default
chat template. Registration happens at import time via the decorators below
(replacing the REGISTER_* macros).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class _Meta:
    def __init__(self):
        self.causal_lm_factory: Optional[Callable] = None
        self.model_args_loader: Optional[Callable[[Dict[str, Any]], Any]] = None
        self.default_chat_template: Optional[Callable] = None


class ModelRegistry:
    _registry: Dict[str, _Meta] = {}

    @classmethod
    def _meta(cls, model_type: str) -> _Meta:
        return cls._registry.setdefault(model_type, _Meta())

    # ---- registration decorators (replace REGISTER_* macros) ----

    @classmethod
    def register_causal_lm(cls, *model_types: str):
        def deco(fn):
            for mt in model_types:
                cls._meta(mt).causal_lm_factory = fn
            return fn

        return deco

    @classmethod
    def register_model_args(cls, *model_types: str):
        def deco(fn):
            for mt in model_types:
                cls._meta(mt).model_args_loader = fn
            return fn

        return deco

    @classmethod
    def register_chat_template(cls, *model_types: str):
        def deco(fn):
            for mt in model_types:
                cls._meta(mt).default_chat_template = fn
            return fn

        return deco

    # ---- lookup ----

    @classmethod
    def supported_model_types(cls):
        return sorted(mt for mt, m in cls._registry.items() if m.causal_lm_factory)

    @classmethod
    def get_causal_lm_factory(cls, model_type: str):
        meta = cls._registry.get(model_type)
        return meta.causal_lm_factory if meta else None

    @classmethod
    def get_model_args_loader(cls, model_type: str):
        meta = cls._registry.get(model_type)
        return meta.model_args_loader if meta else None

    @classmethod
    def get_default_chat_template(cls, model_type: str):
        meta = cls._registry.get(model_type)
        return meta.default_chat_template if meta else None
