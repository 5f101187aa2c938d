"""User-facing errors (parity with scalellm/errors.py in the reference)."""


class ValidationError(Exception):
    """Raised when request parameters fail validation.

    Mirrors the reference's ValidationError(code, message)
    (reference: scalellm/errors.py:1-11).
    """

    def __init__(self, code, message: str):
        super().__init__(message)
        self.code = code
        self.message = message

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ValidationError(code={self.code!r}, message={self.message!r})"
