"""ALiBi slope schedule (arXiv:2108.12409, "Train Short, Test Long"); a copy
of scalellm_tpu/layers/alibi.py.

The paper's geometric schedule, extended to head counts that are not a
power of two the standard way (the 2n schedule's odd entries after the
closest power of two's).
"""

from __future__ import annotations

import math
from typing import List


def alibi_slopes(n_heads: int) -> List[float]:
    def pow2(n: int) -> List[float]:
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(n_heads).is_integer():
        return pow2(n_heads)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = pow2(2 * closest)[0::2][: n_heads - closest]
    return pow2(closest) + extra
