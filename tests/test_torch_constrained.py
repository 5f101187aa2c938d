"""Guided decoding in the port (constrained/, the allowed mask that
Batch.prepare_model_inputs builds, the handler's FsmCache) against the JAX
package, on the CPU, after tests/test_constrained.py:

- the regex and JSON-schema compilers: the same DFA transition and
  accepting tables as scalellm_tpu's for the same patterns;
- the token FSM: the same packed mask rows and next states for every state
  visited, over the char vocabulary and a seeded vocabulary of 2000 ids of
  1-6 characters;
- token_vocab_bytes of the port's tokenizers equals the reference's on its
  tokenizer for the same tokenizer.json (plain, sentencepiece-style and
  byte-level vocabularies);
- LLM.generate: greedy choice, regex, JSON schema and json_object texts
  equal scalellm_tpu.LLM's; n = 2 / best_of = 2 outputs are valid; a mixed
  guided batch served with graphs, eagerly, async and with
  num_decode_steps=4 equals the sync serve; a guided request preempted
  under tight KV (re-prefilled, or swapped out to host memory) gives the
  ample serve's ids;
- refusals: an invalid regex, and guided decoding with speculative
  decoding, are INVALID_ARGUMENT statuses in both packages.
"""

import json
import re

import numpy as np
import pytest

from tests.torch_port_util import generate_within, tiny_llama

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string", "maxLength": 8},
        "count": {"type": "integer"},
    },
    "required": ["name", "count"],
}
TAGS_SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"type": "string"},
        "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}, "maxItems": 3},
    },
    "required": ["name", "age"],
}
CHOICES = ["yes", "no", "maybe"]
PHONE = r"[0-9]{3}-[0-9]{4}"


def _regex(pkg: str, spec):
    """The regex of a table case in package `pkg`'s compilers."""
    js = __import__(f"{pkg}.constrained.json_schema", fromlist=["x"])
    kind, arg = spec
    if kind == "schema":
        return js.schema_regex(arg)
    if kind == "object":
        return js.json_object_regex(arg)
    return arg


TABLE_CASES = {
    "quantifiers": ("regex", r"[ab]{2,4}c?"),
    "number": ("regex", r"-?\d+(?:\.\d+)?"),
    "alternation": ("regex", "(?:red|green|blue)!\\n?"),
    "hex_class": ("regex", r"[\x41-\x43]+"),
    "dead_end": ("regex", "a(?:bc|bd)"),
    "phone": ("regex", PHONE),
    "dot_utf8": ("regex", r"é.[^a-z]{1,3}\w\s\S"),
    "schema": ("schema", SCHEMA),
    "schema_tags": ("schema", TAGS_SCHEMA),
    "json_object_3": ("object", 3),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_dfa_tables_equal_the_reference(case):
    from scalellm_tpu.constrained.fsm import compile_regex as ref_compile
    from scalellm_tpu_torch.constrained.fsm import compile_regex

    ref_rx, rx = _regex("scalellm_tpu", TABLE_CASES[case]), _regex("scalellm_tpu_torch", TABLE_CASES[case])
    assert rx == ref_rx
    want, got = ref_compile(ref_rx), compile_regex(rx)
    assert got.trans.dtype == want.trans.dtype and np.array_equal(got.trans, want.trans)
    assert np.array_equal(got.accepting, want.accepting)


def _vocab(kind: str):
    if kind == "char":
        return [bytes([i]) for i in range(256)]
    rng = np.random.default_rng(0)
    words, seen = [], set()
    while len(words) < 2000 - 256:
        n = int(rng.integers(2, 7))
        w = bytes(rng.integers(32, 127, size=n).tolist())
        if w not in seen:
            seen.add(w)
            words.append(w)
    return [bytes([i]) for i in range(256)] + words


def _visited(fsm, limit=48):
    """States reached from START through allowed tokens, breadth first."""
    from scalellm_tpu_torch.constrained.fsm import DEAD, START
    from scalellm_tpu_torch.constrained.tokenmap import unpack_mask

    order, seen = [START], {START}
    for s in order:
        allowed = np.nonzero(unpack_mask(fsm.allowed_packed(s), fsm.V))[0]
        for t in allowed:
            n = fsm.next_state(s, int(t))
            if n != DEAD and n not in seen and len(order) < limit:
                seen.add(n)
                order.append(n)
    return order


@pytest.mark.parametrize("vocab", ["char", "multi"])
@pytest.mark.parametrize("case", ["quantifiers", "alternation", "dead_end", "phone", "dot_utf8", "schema",
                                  "schema_tags"])
def test_mask_rows_and_next_states_equal_the_reference(case, vocab):
    from scalellm_tpu.constrained.fsm import compile_regex as ref_compile
    from scalellm_tpu.constrained.tokenmap import TokenFsm as RefTokenFsm
    from scalellm_tpu_torch.constrained.fsm import compile_regex
    from scalellm_tpu_torch.constrained.tokenmap import TokenFsm

    tokens = _vocab(vocab)
    eos = (2, 7)
    want = RefTokenFsm(ref_compile(_regex("scalellm_tpu", TABLE_CASES[case])), tokens, eos)
    got = TokenFsm(compile_regex(_regex("scalellm_tpu_torch", TABLE_CASES[case])), tokens, eos)
    assert got.n_words == want.n_words == -(-len(tokens) // 32)
    states = _visited(got)
    assert len(states) > 1
    for s in states:
        g_mask, g_next = got.row(s)
        w_mask, w_next = want.row(s)
        assert g_mask.dtype == w_mask.dtype == np.uint32
        assert np.array_equal(g_mask, w_mask), s
        assert np.array_equal(g_next, w_next), s
        assert got.is_accepting(s) == want.is_accepting(s)


def _tokenizer_spec(kind: str) -> dict:
    """A WordLevel tokenizer.json split into characters (the port reads it
    itself, the reference through `tokenizers`)."""
    if kind == "char":
        vocab = {chr(i): i for i in range(256)}
    else:
        rng = np.random.default_rng(1)
        alphabet = {
            "plain": [chr(c) for c in range(32, 127)],
            "sentencepiece": [chr(c) for c in range(97, 123)] + ["▁"],
            "byte_level": [chr(c) for c in range(0x21, 0x7F)] + ["Ġ", "Ċ", "ĉ"],
        }[kind]
        vocab = {chr(i): i for i in range(256)} if kind == "plain" else {}
        if kind == "sentencepiece":
            for b in range(256):
                vocab[f"<0x{b:02X}>"] = len(vocab)
        while len(vocab) < 600:
            w = "".join(alphabet[int(i)] for i in rng.integers(0, len(alphabet), size=int(rng.integers(1, 6))))
            vocab.setdefault(w, len(vocab))
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": 0, "content": vocab and next(iter(vocab)), "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}] if kind != "char" else [],
        "normalizer": None,
        "pre_tokenizer": {"type": "Split", "pattern": {"String": ""}, "behavior": "Isolated", "invert": False},
        "post_processor": None, "decoder": {"type": "Fuse"},
        "model": {"type": "WordLevel", "vocab": vocab, "unk_token": next(iter(vocab))},
    }


@pytest.mark.parametrize("kind", ["char", "plain", "sentencepiece", "byte_level"])
def test_token_vocab_bytes_equal_the_reference(kind, tmp_path):
    from scalellm_tpu.constrained.guided import token_vocab_bytes as ref_vocab_bytes
    from scalellm_tpu.tokenizer.tokenizer import load_tokenizer as ref_load
    from scalellm_tpu_torch.constrained.guided import token_vocab_bytes
    from scalellm_tpu_torch.tokenizer.tokenizer import WordLevelTokenizer, load_tokenizer

    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(_tokenizer_spec(kind), f)
    tok = load_tokenizer(str(tmp_path))
    assert isinstance(tok, WordLevelTokenizer)
    got, want = token_vocab_bytes(tok), ref_vocab_bytes(ref_load(str(tmp_path)))
    assert len(got) == tok.vocab_size
    assert got == want
    assert token_vocab_bytes(tok) is got  # cached on the tokenizer


# ------------------------------------------------------------------ FSM units


def _full(dfa, s: str) -> bool:
    from scalellm_tpu_torch.constrained.fsm import DEAD, START

    st = dfa.walk(START, s.encode())
    return st != DEAD and bool(dfa.accepting[st])


def test_fsm_units_match_tests_test_constrained():
    """tests/test_constrained.py's FSM unit cases, on the port's modules."""
    from scalellm_tpu_torch.constrained.fsm import START, compile_regex
    from scalellm_tpu_torch.constrained.json_schema import json_object_regex, schema_regex
    from scalellm_tpu_torch.constrained.tokenmap import TokenFsm, pack_bool_mask, unpack_mask

    d = compile_regex(r"[ab]{2,4}c?")
    assert _full(d, "ab") and _full(d, "abab") and _full(d, "ababc")
    assert not _full(d, "a") and not _full(d, "ababab")
    d = compile_regex(r"-?\d+(?:\.\d+)?")
    assert _full(d, "-3.14") and _full(d, "42") and not _full(d, "4.") and not _full(d, "")
    d = compile_regex("(?:red|green|blue)!\\n?")
    assert _full(d, "green!") and _full(d, "red!\n") and not _full(d, "gree")
    d = compile_regex(schema_regex(TAGS_SCHEMA))
    assert _full(d, '{"name": "bob", "age": 4}') and _full(d, '{"name": "b", "age": 12, "tags": ["x", "y"]}')
    assert not _full(d, '{"age": 4}') and not _full(d, '{"name": "b", "age": 1.5}')
    d = compile_regex(json_object_regex(3))
    assert _full(d, '{"a": [1, 2, {"b": null}], "c": "x"}') and _full(d, "{}") and not _full(d, "[1]")
    vocab = [bytes([i]) for i in range(128)]
    tf = TokenFsm(compile_regex("a(?:bc|bd)"), vocab, eos_token_ids=(127,))
    st = tf.next_state(START, ord("a"))
    assert np.nonzero(unpack_mask(tf.allowed_packed(st), 128))[0].tolist() == [ord("b")]
    tf = TokenFsm(compile_regex("hi"), vocab, eos_token_ids=(10,))
    m0 = unpack_mask(tf.allowed_packed(START), 128)
    assert not m0[10] and m0[ord("h")]
    m2 = unpack_mask(tf.allowed_packed(tf.next_state(tf.next_state(START, ord("h")), ord("i"))), 128)
    assert m2[10] and m2.sum() == 1
    m = np.random.default_rng(0).random(1000) > 0.3
    assert (unpack_mask(pack_bool_mask(m), 1000) == m).all()
    tf = TokenFsm(compile_regex("abc"), vocab + [b"ab", b"abc"], eos_token_ids=(0,))
    assert np.nonzero(unpack_mask(tf.allowed_packed(START), 130))[0].tolist() == [ord("a"), 128, 129]


def test_params_reject_multiple_guides():
    from scalellm_tpu_torch.errors import ValidationError
    from scalellm_tpu_torch.sampling.params import SamplingParams

    with pytest.raises(ValidationError):
        SamplingParams(guided_regex="a", guided_choice=["b"]).verify()


def test_batch_mask_rows_follow_each_guided_state():
    """prepare_model_inputs: a guided row carries its state's packed mask,
    an unconstrained row and the padding rows all ones; W is 1 when no row
    is constrained."""
    from scalellm_tpu_torch.constrained.fsm import START, compile_regex
    from scalellm_tpu_torch.constrained.tokenmap import GuidedState, TokenFsm
    from scalellm_tpu_torch.engine.batch import Batch
    from scalellm_tpu_torch.memory.block_manager import BlockManager, BlockManagerOptions
    from scalellm_tpu_torch.request.sequence import Sequence
    from scalellm_tpu_torch.request.stopping import StoppingCriteria
    from scalellm_tpu_torch.sampling.params import SamplingParams

    fsm = TokenFsm(compile_regex("ab+"), [bytes([i]) for i in range(256)], (2,))
    bm = BlockManager(BlockManagerOptions(num_blocks=16, block_size=4, enable_prefix_cache=False))

    def seq(guided):
        s = Sequence(index=0, token_ids=[5, 6, 7], sampling_params=SamplingParams(),
                     stopping_criteria=StoppingCriteria(max_tokens=4), prompt="x", guided=guided)
        assert bm.allocate_blocks_for(s, 3)
        return s

    plain = Batch()
    plain.add(seq(None), 3)
    _, si, _ = plain.prepare_model_inputs(4)
    assert si.allowed_mask.shape[1] == 1
    g = GuidedState(fsm)
    g.advance(ord("a"))
    b = Batch()
    b.add(seq(GuidedState(fsm)), 3)
    b.add(seq(None), 3)
    b.add(seq(g), 3)
    _, si, _ = b.prepare_model_inputs(4)
    S, W = si.allowed_mask.shape
    assert S >= 4 and W == fsm.n_words == 8
    assert np.array_equal(si.allowed_mask[0], fsm.allowed_packed(START))
    assert np.array_equal(si.allowed_mask[2], fsm.allowed_packed(g.state))
    assert (si.allowed_mask[1] == 0xFFFFFFFF).all() and (si.allowed_mask[3:] == 0xFFFFFFFF).all()


# ------------------------------------------------------------------ e2e


GREEDY_CASES = {
    "choice": dict(guided_choice=CHOICES),
    "regex": dict(guided_regex=PHONE),
    "schema": dict(guided_json=SCHEMA),
    "json_object": dict(guided_json="object"),
}


def _valid(case: str, text: str) -> bool:
    if case == "choice":
        return text in CHOICES
    if case == "regex":
        return re.fullmatch(PHONE, text) is not None
    obj = json.loads(text)
    if case == "schema":
        return isinstance(obj["name"], str) and isinstance(obj["count"], int)
    return isinstance(obj, dict)


@pytest.fixture(scope="module")
def llms():
    """One port LLM and one JAX LLM on the tiny Llama, shared by the
    module's generate tests (each keeps its compiled constraints)."""
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu_torch import LLM

    path = tiny_llama()
    port = LLM(path, devices="cpu", block_size=4, num_blocks=256, num_handling_threads=1)
    jax_llm = JaxLLM(path, block_size=4, num_blocks=256, enable_cuda_graph=False, num_handling_threads=1)
    yield port, jax_llm
    port.close()
    jax_llm._handler.stop()


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_guided_texts_equal_the_jax_package(llms, case):
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu_torch import SamplingParams

    port, jax_llm = llms
    max_tokens = 48 if case == "json_object" else 64
    got = generate_within(port, ["produce:", "pick one:"], SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                                                         **GREEDY_CASES[case]))
    want = generate_within(jax_llm, ["produce:", "pick one:"],
                           JaxSamplingParams(max_tokens=max_tokens, temperature=0.0, **GREEDY_CASES[case]))
    for g, w in zip(got, want):
        assert g.status.ok and g.finished
        assert (g.outputs[0].text, g.outputs[0].finish_reason.name) == (w.outputs[0].text,
                                                                        w.outputs[0].finish_reason.name)
        if case != "json_object":  # the tiny model runs json_object to max_tokens
            assert g.outputs[0].finish_reason.name == "STOP" and _valid(case, g.outputs[0].text)


def test_guided_n_sequences_are_each_valid(llms):
    """n = 2, best_of = 2: each sequence walks its own GuidedState (sampled
    rows draw from the port's hash, so texts are held to the constraint,
    not to the reference's)."""
    from scalellm_tpu_torch import SamplingParams

    port, _ = llms
    for sp in (SamplingParams(max_tokens=12, temperature=1.0, n=2, best_of=2, seed=11, guided_choice=["alpha", "beta"]),
               SamplingParams(max_tokens=24, temperature=0.8, n=2, best_of=3, seed=7, guided_regex=PHONE)):
        out = generate_within(port, ["choose:"], sp)[0]
        assert out.status.ok and len(out.outputs) == 2
        for so in out.outputs:
            assert so.text in ("alpha", "beta") if sp.guided_choice else re.fullmatch(PHONE, so.text), so.text


MIXED = [("pick one:", dict(guided_choice=CHOICES)), ("call me at ", dict(guided_regex=PHONE)),
         ("free text ", dict()), ("produce json:", dict(guided_json=SCHEMA)),
         ("another ", dict(guided_regex="[a-z ]{5,12}!"))]

# Beside the sync serve with step graphs (the CPU runs their bucket path
# without a capture).
SERVES = {
    "eager": dict(enable_cuda_graph=False),
    "async": dict(enable_async_scheduling=True),
    "eager_async": dict(enable_cuda_graph=False, enable_async_scheduling=True),
    "ms4": dict(enable_async_scheduling=True, num_decode_steps=4),
}


def _serve_mixed(prompts=None, **kw):
    from scalellm_tpu_torch import LLM, SamplingParams

    kw.setdefault("num_blocks", 256)
    kw.setdefault("enable_async_scheduling", False)
    llm = LLM(tiny_llama(), devices="cpu", block_size=4, num_handling_threads=1, **kw)
    try:
        prompts = prompts or MIXED
        sps = [SamplingParams(max_tokens=40, temperature=0.0, **g) for _, g in prompts]
        outs = generate_within(llm, [p for p, _ in prompts], sps)
        return [(tuple(o.outputs[0].token_ids), o.outputs[0].text, o.outputs[0].finish_reason.name) for o in outs]
    finally:
        llm.close()


@pytest.fixture(scope="module")
def mixed_sync():
    return _serve_mixed()


@pytest.mark.parametrize("serve", list(SERVES))
def test_mixed_guided_batch_serves_equal_the_sync_serve(mixed_sync, serve):
    """A batch of choice, regex, unconstrained, schema and regex rows,
    served eagerly, async (a batch with a guided row steps synchronously)
    and with 4 decode steps a dispatch (such a batch runs single-step): the
    ids of the sync serve with step graphs, each guided text in its
    constraint's language (a prefix of it where max_tokens cut it)."""
    from scalellm_tpu_torch.constrained.guided import constraint_regex
    from scalellm_tpu_torch.sampling.params import SamplingParams

    got = _serve_mixed(**SERVES[serve])
    assert got == mixed_sync
    for (_, guide), (_, text, reason) in zip(MIXED, mixed_sync):
        if guide:
            assert _in_language(constraint_regex(SamplingParams(**guide)), text, whole=reason == "STOP"), text


def _in_language(regex: str, text: str, whole: bool) -> bool:
    """Whether `text` is in the regex's language (whole) or a prefix of a
    word of it (an output cut at max_tokens)."""
    from scalellm_tpu_torch.constrained.fsm import DEAD, START, compile_regex

    dfa = compile_regex(regex)
    st = dfa.walk(START, text.encode())
    return st != DEAD and (not whole or bool(dfa.accepting[st]))


PRESSED = [(f"prompt {i} " + "x" * 24, dict(guided_regex="[a-z]{16,20}") if i % 2 else
            dict(guided_choice=["alpha beta gamma delta", "epsilon zeta eta theta"])) for i in range(4)]


@pytest.mark.parametrize("swap", [False, True])
def test_guided_requests_preempted_give_the_ample_serves_ids(swap):
    """40 blocks of 4 slots hold three of the four requests: the scheduler
    preempts, and the preempted guided sequences resume (re-prefilled, or
    their pages restored from host memory) with their FSM states."""
    from scalellm_tpu_torch.utils.metrics import COUNTERS

    want = _serve_mixed(PRESSED, enable_prefix_cache=False, max_seqs_per_batch=8)
    before = {c: COUNTERS.get(c) for c in ("num_swap_out", "num_preempted_requests")}
    got = _serve_mixed(PRESSED, enable_prefix_cache=False, max_seqs_per_batch=8, num_blocks=40,
                       host_swap_bytes=(64 << 20) if swap else 0)
    moved = {c: COUNTERS.get(c) - v for c, v in before.items()}
    assert got == want
    assert moved["num_preempted_requests"] > 0
    assert (moved["num_swap_out"] > 0) == swap


def _status(llm, sp):
    return generate_within(llm, ["x"], sp)[0].status


def test_refusals_are_invalid_argument_in_both_packages(llms):
    from scalellm_tpu import LLM as JaxLLM
    from scalellm_tpu import SamplingParams as JaxSamplingParams
    from scalellm_tpu import StatusCode as JaxStatusCode
    from scalellm_tpu_torch import LLM, SamplingParams, StatusCode

    port, jax_llm = llms
    bad = dict(guided_regex="(ab", max_tokens=4)
    got, want = _status(port, SamplingParams(**bad)), _status(jax_llm, JaxSamplingParams(**bad))
    assert got.code == StatusCode.INVALID_ARGUMENT and want.code == JaxStatusCode.INVALID_ARGUMENT
    assert got.message == want.message
    spec = dict(num_speculative_tokens=2, num_blocks=64, block_size=4)
    port_spec = LLM(tiny_llama(), devices="cpu", enable_cuda_graph=False, **spec)
    jax_spec = JaxLLM(tiny_llama(), enable_cuda_graph=False, **spec)
    try:
        sp = dict(guided_choice=CHOICES, max_tokens=4)
        got, want = _status(port_spec, SamplingParams(**sp)), _status(jax_spec, JaxSamplingParams(**sp))
        assert got.code == StatusCode.INVALID_ARGUMENT and want.code == JaxStatusCode.INVALID_ARGUMENT
        assert got.message == want.message
    finally:
        port_spec.close()
        jax_spec._handler.stop()
