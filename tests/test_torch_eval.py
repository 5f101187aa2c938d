"""The port's accuracy harness (eval/ppl.py, eval/kv_calibration.py) against
the JAX package's, on the CPU, on the tiny char-level Llama TRAINED on
tests/data/corpus.txt (tests/torch_port_util.trained_tiny_llama, float32),
after tests/test_eval.py:

- calibrate_kv_scales: the same per-layer [k_scale, v_scale] as the JAX
  function, within 1e-5 relative (the amax of f32 K/V computed by sums in
  another order);
- perplexity with float KV, int8 KV at the default scale and int8 KV with
  calibrated scales: the JAX harness's within 1e-4 relative, and the
  reference's own checks (the float model learned the corpus, the calibrated
  int8 KV within 1% of float KV and no worse than the default scale by more
  than 0.1%);
- the calibration CLI's kv_scales.json sidecar read back by both loaders.
"""

import json
import os
import shutil

import numpy as np
import pytest

from tests.torch_port_util import trained_tiny_llama

WINDOW = 256
CONFIGS = {
    "float_kv": dict(),
    "int8_kv": dict(kv_cache_dtype="int8"),
    "int8_kv_calibrated": dict(kv_cache_dtype="int8", calibrate_kv=True),
}


@pytest.fixture(scope="module")
def trained_dir():
    return trained_tiny_llama()


@pytest.fixture(scope="module")
def corpus_ids():
    p = os.path.join(os.path.dirname(__file__), "data", "corpus.txt")
    with open(p, "rb") as f:
        return np.asarray([min(b, 255) for b in f.read()], np.int32)[:2048]


def _jax_ppl(path, ids, **kw):
    from scalellm_tpu.eval.ppl import load_for_eval, perplexity

    if kw.get("calibrate_kv"):
        kw["calib_tokens"] = ids[:1024]
    model, params = load_for_eval(path, dtype="float32", **kw)
    return perplexity(model, params, ids, window=WINDOW)


def _port_ppl(path, ids, **kw):
    from scalellm_tpu_torch.eval.ppl import load_for_eval, perplexity

    if kw.get("calibrate_kv"):
        kw["calib_tokens"] = ids[:1024]
    model = load_for_eval(path, dtype="float32", device="cpu", **kw)
    return perplexity(model, ids, window=WINDOW)


@pytest.fixture(scope="module")
def ppls(trained_dir, corpus_ids):
    """config -> (the port's result, the JAX package's), computed once."""
    cache = {}

    def get(config):
        if config not in cache:
            kw = CONFIGS[config]
            cache[config] = (_port_ppl(trained_dir, corpus_ids, **kw), _jax_ppl(trained_dir, corpus_ids, **kw))
        return cache[config]

    return get


def test_calibrated_scales_match_jax(trained_dir, corpus_ids):
    from scalellm_tpu.eval.kv_calibration import calibrate_kv_scales as jax_calibrate
    from scalellm_tpu.eval.ppl import load_for_eval as jax_load
    from scalellm_tpu_torch.eval.kv_calibration import calibrate_kv_scales
    from scalellm_tpu_torch.eval.ppl import load_for_eval

    jmodel, params = jax_load(trained_dir, dtype="float32", kv_cache_dtype="int8")
    want = np.asarray(jax_calibrate(jmodel, params, corpus_ids[:1024], window=WINDOW))
    model = load_for_eval(trained_dir, dtype="float32", kv_cache_dtype="int8", device="cpu")
    got = calibrate_kv_scales(model, corpus_ids[:1024], window=WINDOW)
    assert got.shape == (2, 2) and got.dtype.is_floating_point
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    assert not np.allclose(want, model.args.kv_scale)  # calibration moved them off the default


@pytest.mark.parametrize("config", list(CONFIGS))
def test_perplexity_matches_jax(config, ppls):
    got, want = ppls(config)
    assert got["tokens"] == want["tokens"] == 8 * (WINDOW - 1)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-4)
    np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-4)


def test_calibration_beats_the_default_scale(ppls):
    """The reference's checks (tests/test_eval.py), on the port's numbers."""
    base = ppls("float_kv")[0]["ppl"]
    default = ppls("int8_kv")[0]["ppl"]
    calibrated = ppls("int8_kv_calibrated")[0]["ppl"]
    assert base < 20.0  # the fixture learned the corpus (uniform over 256: 256)
    assert (calibrated - base) / base < 0.01
    assert calibrated <= default * 1.001


def test_kv_scales_sidecar_round_trip(trained_dir, tmp_path):
    """The port's calibration CLI writes a sidecar that both packages'
    loaders read; its scales are the JAX CLI's."""
    from scalellm_tpu.eval.kv_calibration import main as jax_main
    from scalellm_tpu.eval.ppl import load_for_eval as jax_load
    from scalellm_tpu_torch.eval.kv_calibration import main
    from scalellm_tpu_torch.eval.ppl import load_for_eval

    d, dj = str(tmp_path / "model"), str(tmp_path / "model_jax")
    shutil.copytree(trained_dir, d)
    shutil.copytree(trained_dir, dj)
    text = str(tmp_path / "calib.txt")
    with open(text, "w") as f:
        f.write("the quick brown fox jumps over the lazy dog. " * 50)
    cli = ["--text", text, "--max-tokens", "1024", "--window", str(WINDOW), "--cpu"]
    main(["--model", d] + cli)
    jax_main(["--model", dj] + cli)
    with open(os.path.join(d, "kv_scales.json")) as f:
        data = json.load(f)
    with open(os.path.join(dj, "kv_scales.json")) as f:
        data_jax = json.load(f)
    assert len(data["k"]) == len(data["v"]) == 2  # n_layers
    np.testing.assert_allclose(np.asarray([data["k"], data["v"]]), np.asarray([data_jax["k"], data_jax["v"]]),
                               rtol=1e-5)
    want = np.stack([data["k"], data["v"]], axis=1).astype(np.float32)
    _, params = jax_load(d, dtype="float32", kv_cache_dtype="int8")
    np.testing.assert_array_equal(np.asarray(params["layers"]["kv_scales"]), want)
    model = load_for_eval(d, dtype="float32", kv_cache_dtype="int8", device="cpu")
    np.testing.assert_array_equal(model.kv_scales.numpy(), want)
