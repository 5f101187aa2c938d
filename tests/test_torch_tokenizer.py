"""The port's host-side readers against the packages the JAX package uses:
its WordLevel tokenizer.json reader against `tokenizers` (through the JAX
package's HFTokenizer), and its safetensors reader against `safetensors`.
The card's machine has neither package, so the port reads both formats
itself."""

import numpy as np
import pytest
import torch

import tests.fixtures as fixtures

TEXTS = ["hello world, hello world", "a\tb\nc", "", "ÿ~ ", "\x00x"]


@pytest.fixture(scope="module")
def char_tokenizer_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("char_tokenizer")
    fixtures.save_char_tokenizer(str(d))
    return str(d)


def test_word_level_tokenizer_matches_tokenizers(char_tokenizer_dir):
    from scalellm_tpu.tokenizer.tokenizer import HFTokenizer
    from scalellm_tpu_torch.tokenizer.tokenizer import WordLevelTokenizer, load_tokenizer

    want = HFTokenizer.from_file(f"{char_tokenizer_dir}/tokenizer.json")
    got = load_tokenizer(char_tokenizer_dir)
    assert isinstance(got, WordLevelTokenizer)
    assert got.vocab_size == want.vocab_size
    for text in TEXTS:
        ids = got.encode(text)
        assert ids == want.encode(text)
        assert got.decode(ids) == want.decode(ids)
    # Ids past the vocab (a model's vocab may be larger) decode to "".
    ids = [104, 300, 105, 31999]
    assert got.decode(ids) == want.decode(ids) == "hi"
    for i in ids:
        assert got.id_to_token(i) == want.id_to_token(i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_safetensors_reader_matches_safetensors(tmp_path, dtype):
    from safetensors.torch import save_file

    from scalellm_tpu_torch.model_loader.loader import read_safetensors

    rng = np.random.default_rng(0)
    tensors = {
        "w": torch.from_numpy(rng.standard_normal((5, 3)).astype(np.float32)).to(dtype),
        "b": torch.from_numpy(rng.standard_normal(7).astype(np.float32)).to(dtype),
        "empty": torch.zeros((0, 4), dtype=dtype),
    }
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = {name: t.clone() for name, t in read_safetensors(path)}
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        assert got[name].dtype == dtype and got[name].shape == t.shape
        assert torch.equal(got[name], t), name
