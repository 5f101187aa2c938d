"""One rank of the port's tensor-parallel runs in the CPU tests:
`python -m tests.torch_tp_worker SPEC RANK` (torch_port_util.spawn starts
one a rank). It joins the spec's gloo world, runs each case of the spec on
its slice and writes what it computed to SPEC's "out" + ".rank<R>.npz".
It imports no JAX.

Cases:
  model: the checkpoint at "dir" (float32) under tp = the world size and
         "sp", through forward + logits over the steps of the npz "steps"
         (step i's ModelInputs arrays under "i/<field>"); writes
         "<name>/<i>" = the step's logits [S, V] (every rank has them);
         "quant_ref" runs quantized projections through the float
         reference (variant "ref").
  a2a:   layers/moe.moe_mlp_a2a over the world on inputs made from "seed"
         (a2a_inputs); writes "<name>" = this rank's output rows.
  broadcast: rank 0 broadcasts a step's ModelInputs / SamplingInputs
         (bucket "header": engine/distributed.py's header) filled with
         numbers from "seed", the others their placeholders; writes
         "<name>/<field>" = what each rank holds after it.
  wedged: rank 0 broadcasts one header, then stays alive without
         broadcasting for "hold" seconds; the others wait for a second
         header with multihost.broadcast_with_timeout("timeout"); writes
         "<name>" = 1 where that raised RuntimeError, 0 where a header came.
"""

import functools
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

PAGE = 4
NUM_PAGES = 16


def step_arrays(chunks, S=4, T=16, maxp=4):
    """ModelInputs arrays of one step (tests/test_torch_model.py's _inputs):
    chunks are (seq index, first position, token ids) per scheduled
    sequence; sequence i owns pages 1 + i*maxp ... (page 0 pads)."""
    tok, pos, seg, slots = (np.zeros(T, np.int32) for _ in range(4))
    tables = np.zeros((S, maxp), np.int32)
    kv_lens, sel = np.zeros(S, np.int32), np.zeros(S, np.int32)
    cu = np.zeros(S + 1, np.int32)
    mask = np.zeros(S, np.float32)
    t = 0
    for s, (i, start, ids) in enumerate(chunks):
        n = len(ids)
        pages = 1 + i * maxp + np.arange(maxp)
        p = np.arange(start, start + n)
        tok[t : t + n], pos[t : t + n], seg[t : t + n] = ids, p, s
        slots[t : t + n] = pages[p // PAGE] * PAGE + p % PAGE
        tables[s], kv_lens[s], cu[s + 1], sel[s], mask[s] = pages, start + n, t + n, t + n - 1, 1.0
        t += n
    cu[len(chunks) + 1 :] = cu[len(chunks)]
    return dict(token_ids=tok, positions=pos, token_seg=seg, new_kv_slot_ids=slots, block_tables=tables,
                kv_lens=kv_lens, cu_q_lens=cu, num_seqs=np.array([len(chunks)], np.int32), selected_idxes=sel,
                seq_mask=mask)


def a2a_inputs(seed, T, D, F, E, skew=False):
    """(x [T, D], router [D, E], gate / up [E, D, F], down [E, F, D]) f32 in
    the reference's layout (tests/test_moe_a2a.py's _make_weights); skew
    biases the router towards experts 2 and 3."""
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(D, E)).astype(np.float32)
    gate, up = (rng.normal(size=(E, D, F)).astype(np.float32) * 0.2 for _ in range(2))
    down = rng.normal(size=(E, F, D)).astype(np.float32) * 0.2
    if skew:
        router[:, 2] += 50.0
        router[:, 3] += 40.0
    x = rng.normal(size=(T, D)).astype(np.float32)
    return x, router, gate, up, down


def run_model(case, mesh):
    import scalellm_tpu_torch.models  # noqa: F401  (registers the models)
    from scalellm_tpu_torch.engine.params import ModelInputs
    from scalellm_tpu_torch.model_loader.loader import HFModelLoader
    from scalellm_tpu_torch.models.registry import ModelRegistry
    from scalellm_tpu_torch.ops.quant_matmul import quant_matmul
    from scalellm_tpu_torch.parallel import ParallelConfig

    loader = HFModelLoader(case["dir"])
    loader.model_args.dtype = "float32"
    parallel = ParallelConfig(tp_axis="tp", tp_size=mesh.tp_size, sp=case.get("sp", False))
    factory = ModelRegistry.get_causal_lm_factory(loader.model_type)
    model = loader.load_model(factory(loader.model_args, device="meta", parallel=parallel, mesh=mesh), "cpu")
    if case.get("quant_ref"):
        model.quant_impl = functools.partial(quant_matmul, variant="ref")
    kv = torch.zeros(model.kv_cache_shape(NUM_PAGES, PAGE), dtype=model.kv_cache_dtype())
    steps = np.load(case["steps"])
    out = {}
    with torch.inference_mode():
        for i in range(len({k.split("/")[0] for k in steps.files})):
            mi = ModelInputs(**{k.split("/")[1]: steps[k] for k in steps.files if k.startswith(f"{i}/")})
            out[f"{case['name']}/{i}"] = model.logits(model(kv, mi.to("cpu"))).numpy()
    return out


def run_a2a(case, mesh):
    from scalellm_tpu_torch.layers.moe import moe_mlp_a2a

    x, router, gate, up, down = a2a_inputs(case["seed"], case["T"], case["D"], case["F"], case["E"],
                                           case.get("skew", False))
    n, e = case["T"] // mesh.tp_size, case["E"] // mesh.tp_size
    mine = slice(mesh.tp_rank * e, (mesh.tp_rank + 1) * e)
    t = torch.from_numpy
    y = moe_mlp_a2a(t(x[mesh.tp_rank * n : (mesh.tp_rank + 1) * n]), t(router.T.copy()),
                    t(gate[mine].transpose(0, 2, 1).copy()), t(up[mine].transpose(0, 2, 1).copy()),
                    t(down[mine].transpose(0, 2, 1).copy()), case["top_k"], case.get("norm", False),
                    mesh=mesh)
    return {case["name"]: y.numpy()}


def run_broadcast(case, mesh):
    import dataclasses

    from scalellm_tpu_torch.engine.distributed import _placeholders
    from scalellm_tpu_torch.parallel import multihost

    mi, si = _placeholders(np.asarray(case["header"], np.int32))
    if mesh.rank == 0:
        rng = np.random.default_rng(case["seed"])
        mi, si = (dataclasses.replace(x, **{
            f.name: rng.integers(0, 1000, getattr(x, f.name).shape).astype(getattr(x, f.name).dtype)
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}) for x in (mi, si))
    mi, si = multihost.broadcast_step_inputs(mi, si)
    return {f"{case['name']}/{f.name}": getattr(x, f.name) for x in (mi, si) for f in dataclasses.fields(x)
            if getattr(x, f.name) is not None}


def run_wedged(case, mesh):
    import time

    from scalellm_tpu_torch.parallel import multihost

    header = np.arange(9, dtype=np.int32)
    if mesh.rank == 0:
        multihost.broadcast_step_inputs(header)
        time.sleep(case["hold"])  # alive, never broadcasts again
        return {case["name"]: np.array(0)}
    multihost.broadcast_with_timeout(np.zeros(9, np.int32), timeout=60.0)
    try:
        multihost.broadcast_with_timeout(np.zeros(9, np.int32), timeout=case["timeout"])
    except RuntimeError:
        return {case["name"]: np.array(1)}
    return {case["name"]: np.array(0)}


def main(spec_path: str, rank: int) -> None:
    from scalellm_tpu_torch.parallel import multihost

    with open(spec_path) as f:
        spec = json.load(f)
    multihost.init_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank, "gloo")
    try:
        mesh = multihost.make_pod_mesh(tp=spec["world"], device="cpu")
        out = {}
        for case in spec["cases"]:
            out.update({"model": run_model, "a2a": run_a2a, "broadcast": run_broadcast,
                        "wedged": run_wedged}[case["kind"]](case, mesh))
        np.savez(f"{spec['out']}.rank{rank}.npz", **out)
    finally:
        if not any(case["kind"] == "wedged" for case in spec["cases"]):
            multihost.shutdown_distributed()
    # A wedged case leaves a broadcast thread blocked: exit without waiting
    # for it.
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
