"""The port's tensor, sequence and expert parallelism against the JAX
package's sharded run (tests/test_parallel.py's role): each family's tiny
float32 checkpoint through forward + logits over four steps (prefill
chunks, a mixed step, decodes; T = 16, so SP's gate is open), in the port
at tp = 2 (and 4) as gloo processes (tests/torch_tp_worker.py, one a rank,
started with torch_port_util.spawn, several families a world), in the JAX
package under shard_map on its 8-device CPU mesh at the same tp, and in
both at tp 1.

Each step's logits: the port's sharded run vs the JAX package's sharded run
and vs the port's tp 1, within TOL = 1e-4 (float32 everywhere; the ranks'
partial sums are added in another order than one device's, which moves
logits by about 1e-6); greedy ids equal across the four runs. Cases:
Llama at tp 2 and at tp 4 (2 KV heads over 4 ranks: each KV head held by
two ranks), Qwen2 (qkv bias), Mixtral (4 experts: 2 a rank at tp 2, one at
tp 4), MPT and BLOOM (ALiBi slopes per rank, tied vocab-parallel
embedding), Gemma2 (sliding windows, soft caps), the AWQ INT4 checkpoint of
tests/test_parallel.py (quantized projections through the float reference,
variant "ref", as the JAX package computes them on the CPU), and Megatron SP
on Llama (tp 2 and 4) and Qwen2. Then the loader and runtime quantization
per rank: each rank's state dict vs the slices of the tp 1 model's, and
runtime INT4 of a rank's slice vs the slice of the INT4 model.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from tests.torch_port_util import output, spawn, stop_all
from tests.torch_tp_worker import NUM_PAGES, PAGE, step_arrays

TOL = 1e-4
WORKER = "tests.torch_tp_worker"
WORLD_S = 240

# name -> (checkpoint, tp, sp, quantized)
CASES = {
    "llama": ("llama", 2, False, False),
    "qwen2": ("qwen2", 2, False, False),
    "mixtral": ("mixtral", 2, False, False),
    "mpt": ("mpt", 2, False, False),
    "bloom": ("bloom", 2, False, False),
    "gemma2": ("gemma2", 2, False, False),
    "awq": ("awq", 2, False, True),
    "llama_sp": ("llama", 2, True, False),
    "qwen2_sp": ("qwen2", 2, True, False),
    "llama_tp4": ("llama", 4, False, False),
    "mixtral_tp4": ("mixtral", 4, False, False),
    "llama_sp_tp4": ("llama", 4, True, False),
}


def _steps(vocab):
    rng = np.random.default_rng(0)
    p = [rng.integers(0, vocab, n).tolist() for n in (8, 10, 5)]
    return [
        [(0, 0, p[0][:7]), (1, 0, p[1][:5])],
        [(0, 7, p[0][7:]), (1, 5, p[1][5:9]), (2, 0, p[2][:3])],
        [(0, 8, [11]), (1, 9, p[1][9:]), (2, 3, p[2][3:4])],
        [(0, 9, [12]), (1, 10, [13]), (2, 4, p[2][4:])],
    ]


def _mesh(tp):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))


def jax_logits(model_dir, tp, sp, steps):
    """The JAX package's forward + logits of each step (float32), sharded
    over tp devices of the CPU mesh by shard_map with the model's partition
    specs (tests/test_parallel.py's _greedy_step, keeping the logits)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from scalellm_tpu.engine.executor import Executor
    from scalellm_tpu.engine.params import ModelInputs
    from scalellm_tpu.model_loader import HFModelLoader
    from scalellm_tpu.models.registry import ModelRegistry
    from scalellm_tpu.parallel.config import ParallelConfig

    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    loader = HFModelLoader(model_dir)
    loader.model_args.dtype = "float32"
    parallel = ParallelConfig(tp_axis="tp" if tp > 1 else None, tp_size=tp, sp=sp)
    model = ModelRegistry.get_causal_lm_factory(loader.model_type)(loader.model_args, parallel)
    mesh = _mesh(tp) if tp > 1 else None
    ex = Executor(model, loader.load_params(model), mesh=mesh)
    ex.init_kv_cache(num_blocks=NUM_PAGES, block_size=PAGE)

    def step(params, kv, mi):
        h, kv = model.forward(params, kv, mi)
        return model.logits(params, h), kv

    if mesh is None:
        fn = jax.jit(step)
    else:
        kv_spec = model.kv_cache_partition_spec()
        fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(model.param_partition_specs(), kv_spec,
                                                          ex._shard_specs()[0]),
                               out_specs=(P(), kv_spec), check_vma=False))
    kv, out = ex.kv_cache, []
    for arrays in steps:
        logits, kv = fn(ex.params, kv, ModelInputs(**{k: jnp.asarray(v) for k, v in arrays.items()}))
        out.append(np.asarray(logits))
    return out


def port_logits_tp1(model_dir, steps, quant_ref):
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry
    from scalellm_tpu_torch.ops.quant_matmul import quant_matmul

    loader = HFModelLoader(model_dir)
    loader.model_args.dtype = "float32"
    model = loader.load_model(ModelRegistry.get_causal_lm_factory(loader.model_type)(
        loader.model_args, device="meta"), "cpu")
    if quant_ref:
        model.quant_impl = functools.partial(quant_matmul, variant="ref")
    kv = torch.zeros(model.kv_cache_shape(NUM_PAGES, PAGE), dtype=model.kv_cache_dtype())
    with torch.inference_mode():
        return [model.logits(model(kv, ModelInputs(**a).to("cpu"))).numpy() for a in steps]


def run_world(tmp_path, tag, world, cases):
    """Each case through tests/torch_tp_worker.py in a gloo world of `world`
    processes; rank 0's outputs (and every rank's, for a2a) by rank."""
    from tests.torch_port_util import free_port

    out = str(tmp_path / tag)
    spec = tmp_path / f"{tag}.json"
    spec.write_text(json.dumps({"port": free_port(), "world": world, "out": out, "cases": cases}))
    procs = [spawn(WORKER, str(spec), str(r)) for r in range(world)]
    try:
        codes = [p.wait(timeout=WORLD_S) for p in procs]
    finally:
        stop_all(procs)
    for r, (p, c) in enumerate(zip(procs, codes)):
        assert c == 0, f"rank {r} exited with {c}:\n{output(p)[-4000:]}"
    return [dict(np.load(f"{out}.rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (port tp, jax tp, port tp 1, jax tp 1)} logits lists."""
    import tests.fixtures as fixtures
    import tests.test_quantization as tq
    from tests.test_model_zoo import make_checkpoint

    tmp = tmp_path_factory.mktemp("tp")
    dirs = {f: make_checkpoint(tmp, f)[0] for f in ("llama", "qwen2", "mixtral", "mpt", "bloom", "gemma2")}
    src = str(tmp / "awq_src")
    fixtures.make_tiny_llama(src, tokenizer=True)
    dirs["awq"] = tq._quantize_checkpoint(src, str(tmp / "awq"), "awq")[0]
    steps, step_files = {}, {}
    for ckpt, d in dirs.items():
        with open(os.path.join(d, "config.json")) as f:
            vocab = json.load(f)["vocab_size"]
        steps[ckpt] = [step_arrays(chunks) for chunks in _steps(vocab)]
        step_files[ckpt] = str(tmp / f"{ckpt}_steps.npz")
        np.savez(step_files[ckpt], **{f"{i}/{k}": v for i, a in enumerate(steps[ckpt]) for k, v in a.items()})
    worlds = {}
    for world in (2, 4):
        cases = [dict(kind="model", name=name, dir=dirs[ckpt], sp=sp, quant_ref=quant, steps=step_files[ckpt])
                 for name, (ckpt, tp, sp, quant) in CASES.items() if tp == world]
        worlds[world] = run_world(tmp, f"world{world}", world, cases)[0]
    out, single = {}, {}
    for name, (ckpt, tp, sp, quant) in CASES.items():
        if ckpt not in single:
            single[ckpt] = (port_logits_tp1(dirs[ckpt], steps[ckpt], quant), jax_logits(dirs[ckpt], 1, False,
                                                                                       steps[ckpt]))
        port = [worlds[tp][f"{name}/{i}"] for i in range(len(steps[ckpt]))]
        out[name] = (port, jax_logits(dirs[ckpt], tp, sp, steps[ckpt]), *single[ckpt])
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_tp_logits_match_the_sharded_reference_and_tp1(runs, name):
    port, jax_tp, port1, jax1 = runs[name]
    for i, (got, want, one, jone) in enumerate(zip(port, jax_tp, port1, jax1)):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=f"step {i} vs the JAX sharded run")
        np.testing.assert_allclose(got, one, atol=TOL, rtol=0, err_msg=f"step {i} vs the port at tp 1")
        ids = {tuple(x.argmax(-1)) for x in (got, want, one, jone)}
        assert len(ids) == 1, f"step {i}: greedy ids differ: {ids}"


# ------------------------------------------------------- loader and quantization

def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


class _Mesh:
    """A rank's mesh for building and loading a model (no collective runs)."""

    def __init__(self, tp, rank):
        self.tp_size, self.tp_rank = tp, rank


def _load(model_dir, tp=1, rank=0, quantize="", dtype="float32"):
    import scalellm_tpu_torch.models  # noqa: F401
    from scalellm_tpu_torch.config import QuantArgs
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry
    from scalellm_tpu_torch.parallel import ParallelConfig
    from scalellm_tpu_torch.quantization.runtime import quantize_model

    loader = HFModelLoader(model_dir)
    loader.model_args.dtype = dtype
    kw = dict(parallel=ParallelConfig(tp_size=tp), mesh=_Mesh(tp, rank)) if tp > 1 else {}
    model = loader.load_model(ModelRegistry.get_causal_lm_factory(loader.model_type)(
        loader.model_args, device="meta", **kw), "cpu")
    if quantize:
        model = quantize_model(model, QuantArgs(quant_method="internal", bits=4, group_size=32))
    return model


FUSED_PARTS = {"qkv_proj": ("q", "kv", "kv"), "qkv_bias": ("q", "kv", "kv"), "gate_up_proj": ("f", "f"),
               "gate_up_bias": ("f", "f")}


@pytest.mark.parametrize("family", ["llama", "qwen2", "mixtral", "mpt"])
def test_each_rank_loads_its_slice(tmp_path, family):
    """The two ranks' loaded state dicts put back together give the tp 1
    model's: an unsplit tensor equal on both ranks, a split one (o/down
    along K, the vocabulary, the experts) the ranks' slices concatenated
    along its split dim, a fused one (q/k/v, gate/up) each part's slices
    concatenated part by part."""
    from tests.test_model_zoo import make_checkpoint

    d = make_checkpoint(tmp_path, family)[0]
    whole = _state(_load(d))
    models = [_load(d, 2, r) for r in range(2)]
    ranks = [_state(m) for m in models]
    for name, full in whole.items():
        parts = [r[name] for r in ranks]
        if parts[0].shape == full.shape:
            for p in parts:
                assert torch.equal(p, full), name
            continue
        dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, full.shape)) if a != b)
        fused = FUSED_PARTS.get(name.rpartition(".")[2])
        if fused is None:
            assert torch.equal(torch.cat(parts, dim), full), name
            continue
        # [q_r | k_r | v_r] / [gate_r | up_r]: rank r's piece of each part.
        m = models[0]
        widths = {"q": m.shard.heads * m.args.head_dim, "kv": m.shard.kv_heads * m.args.head_dim,
                  "f": m.shard.ffn}
        pieces = [p.split([widths[k] for k in fused], dim) for p in parts]
        glued = torch.cat([torch.cat([pc[j] for pc in pieces], dim) for j in range(len(fused))], dim)
        assert torch.equal(glued, full), name


def test_runtime_int4_of_a_slice_is_the_slice_of_int4(tmp_path):
    """Quantizing a rank's slice (groups along K within a column; the
    row-parallel slice starts at a multiple of the group) gives exactly the
    quantized model's slice, for every quantized buffer of both ranks."""
    import tests.fixtures as fixtures

    d = str(tmp_path / "m")
    fixtures.make_tiny_llama(d, hidden_size=128, intermediate_size=256)
    whole = _load(d, quantize="int4", dtype="bfloat16")
    for rank in range(2):
        part = _state(_load(d, 2, rank, quantize="int4", dtype="bfloat16"))
        ref = _load(d, 2, rank, dtype="bfloat16")  # for shard_weight's widths
        for name, t in part.items():
            if name.rpartition(".")[2] not in ("qweight", "scales"):
                continue
            # shard_weight cuts a fused whole tensor part by part.
            assert torch.equal(t, ref.shard_weight(name, whole.state_dict()[name])), name


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_convert_params_per_rank_equals_the_rank_loader(tmp_path, family):
    """convert_params(params, args, model) of the JAX package's tp 1
    parameters is, for each rank's model, exactly the state dict that
    rank's loader reads from the checkpoint."""
    from scalellm_tpu.model_loader import HFModelLoader as JaxLoader
    from scalellm_tpu.models.registry import ModelRegistry as JaxRegistry
    from scalellm_tpu.parallel.config import ParallelConfig as JaxParallel
    from scalellm_tpu_torch.models.common import convert_params
    from tests.test_model_zoo import make_checkpoint

    d = make_checkpoint(tmp_path, family)[0]
    loader = JaxLoader(d)
    loader.model_args.dtype = "float32"
    jmodel = JaxRegistry.get_causal_lm_factory(loader.model_type)(loader.model_args, JaxParallel())
    params = loader.load_params(jmodel)
    for rank in range(2):
        model = _load(d, 2, rank)
        got = convert_params(params, model.args, model)
        want = _state(model)
        assert sorted(got) == sorted(want)
        for name, t in want.items():
            assert torch.equal(got[name].to(t.dtype), t), (rank, name)
