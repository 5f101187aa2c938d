"""Token-level FSM over a byte DFA: per-state allowed-token bitmasks.

Binds a byte-level :class:`~scalellm_tpu_torch.constrained.fsm.Dfa` to a
tokenizer vocabulary. For a DFA state ``s``, token ``t`` (byte string
``bytes(t)``) is allowed iff walking its bytes from ``s`` never hits the
dead state; the walk's end state is the next FSM state after emitting
``t``. EOS is allowed iff ``s`` is accepting.

The per-state vocab walk is fully vectorized: token bytes live in a padded
``[V, Lmax]`` uint8 matrix and the walk is ``Lmax`` numpy gathers
``state = trans[state, byte_col]`` over all V tokens at once (dead state 0
is absorbing, padding bytes are routed via an identity column). Rows are
computed lazily on first visit and cached — typical guided generations
touch a few hundred states out of potentially tens of thousands.

Masks are returned PACKED as uint32[ceil(V/32)] little-endian bit order
(token id v → word v>>5, bit v&31), matching the device-side unpack in
sampling/sampler.py:apply_allowed_mask.

A copy of scalellm_tpu/constrained/tokenmap.py.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from scalellm_tpu_torch.constrained.fsm import DEAD, START, Dfa


def pack_bool_mask(mask: np.ndarray) -> np.ndarray:
    """bool[V] → uint32[ceil(V/32)] (little-endian bit order)."""
    V = mask.shape[0]
    pad = (-V) % 32
    if pad:
        mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
    by = np.packbits(mask.reshape(-1, 32), axis=-1, bitorder="little")  # [W, 4]
    return np.ascontiguousarray(by).view(np.uint32).reshape(-1)


def unpack_mask(packed: np.ndarray, V: int) -> np.ndarray:
    """Inverse of pack_bool_mask (testing helper)."""
    words = packed.view(np.uint32)
    out = np.zeros(V, dtype=bool)
    for v in range(V):
        out[v] = (words[v >> 5] >> (v & 31)) & 1
    return out


class TokenFsm:
    """DFA + vocabulary binding with lazy per-state mask rows.

    Thread-safe: handler threads may race on the same cached TokenFsm.
    """

    def __init__(
        self,
        dfa: Dfa,
        token_bytes: List[bytes],
        eos_token_ids: Tuple[int, ...],
    ):
        self.dfa = dfa
        self.eos_token_ids = tuple(eos_token_ids)
        V = len(token_bytes)
        self.V = V
        self.n_words = (V + 31) // 32
        Lmax = max((len(b) for b in token_bytes), default=1) or 1
        # byte matrix: column Lmax acts as "no byte" (identity transition)
        self._bytes = np.zeros((V, Lmax), dtype=np.int32)
        self._lens = np.zeros(V, dtype=np.int32)
        for v, b in enumerate(token_bytes):
            self._lens[v] = len(b)
            if b:
                self._bytes[v, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        self._pos_lt_len = (
            np.arange(Lmax, dtype=np.int32)[None, :] < self._lens[:, None]
        )  # [V, Lmax]
        # tokens with no bytes (specials) are never allowed mid-constraint
        self._empty = self._lens == 0
        self._lock = threading.Lock()
        self._rows: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}

    def _compute_row(self, state: int) -> Tuple[np.ndarray, np.ndarray]:
        trans = self.dfa.trans
        st = np.full(self.V, state, dtype=np.int32)
        for col in range(self._bytes.shape[1]):
            nxt = trans[st, self._bytes[:, col]]
            st = np.where(self._pos_lt_len[:, col], nxt, st)
        allowed = (st != DEAD) & ~self._empty
        # EOS: allowed iff the state is accepting; EOS does not consume bytes.
        if self.dfa.accepting[state]:
            for e in self.eos_token_ids:
                if 0 <= e < self.V:
                    allowed[e] = True
                    st[e] = state
        else:
            for e in self.eos_token_ids:
                if 0 <= e < self.V:
                    allowed[e] = False
        packed = pack_bool_mask(allowed)
        return packed, st.astype(np.int32)

    def row(self, state: int) -> Tuple[np.ndarray, np.ndarray]:
        """(packed_mask uint32[n_words], next_state int32[V]) for a state."""
        r = self._rows.get(state)
        if r is None:
            with self._lock:
                r = self._rows.get(state)
                if r is None:
                    r = self._compute_row(state)
                    self._rows[state] = r
        return r

    def allowed_packed(self, state: int) -> np.ndarray:
        return self.row(state)[0]

    def next_state(self, state: int, token_id: int) -> int:
        return int(self.row(state)[1][token_id])

    def is_accepting(self, state: int) -> bool:
        return bool(self.dfa.accepting[state])

    def has_live_tokens(self, state: int) -> bool:
        return bool(self.allowed_packed(state).any())


class GuidedState:
    """Per-sequence cursor over a shared TokenFsm."""

    __slots__ = ("fsm", "state", "finished")

    def __init__(self, fsm: TokenFsm, state: int = START, finished: bool = False):
        self.fsm = fsm
        self.state = state
        self.finished = finished

    def mask(self) -> Optional[np.ndarray]:
        """Packed allowed-token mask for the next step (None once done)."""
        if self.finished:
            return None
        return self.fsm.allowed_packed(self.state)

    def advance(self, token_id: int) -> None:
        if self.finished:
            return
        if token_id in self.fsm.eos_token_ids:
            self.finished = True
            return
        self.state = self.fsm.next_state(self.state, token_id)
        if self.state == DEAD:
            # Should not happen under masking; fail open (stop constraining)
            self.finished = True

    def exhausted(self) -> bool:
        """True when no token (incl. EOS) is allowed — caller should
        finish the sequence (malformed constraint or mid-UTF8 dead end)."""
        return not self.finished and not self.fsm.has_live_tokens(self.state)

    def clone(self) -> "GuidedState":
        return GuidedState(self.fsm, self.state, self.finished)
