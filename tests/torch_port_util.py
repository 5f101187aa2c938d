"""Shared helpers of the tests that hold the PyTorch port to the JAX package.

Importing it sets torch's intra-op pool to one thread: every test process
imports it while it collects the port's tests, before any test runs. With
several test processes on the machine's cores, a pool of all the cores
stalls at each of torch's many small parallel regions (a training build
took minutes where it takes about 30 s alone); the JAX package's thread
pools are left as they are."""

import numpy as np
import torch

torch.set_num_threads(1)


def ragged_batch(rng, *, q_lens, kv_lens, S, T, n_heads, n_kv_heads, head_dim,
                 page_size=4, num_pages=64, dtype=np.float32):
    """Random inputs of ragged paged attention, as numpy arrays.

    Real sequence i has a chunk of q_lens[i] query tokens at the tail of a
    context of kv_lens[i] tokens; sequence slots past len(q_lens) are
    padding (kv_len 0, cu_q_lens repeating its last value) and token rows
    past sum(q_lens) are bucket padding. Pages are distinct and never page 0
    (the reserved padding page)."""
    n_real = len(q_lens)
    maxp = max(-(-k // page_size) for k in kv_lens)
    q = rng.standard_normal((T, n_heads, head_dim)).astype(dtype)
    kv_pages = rng.standard_normal(
        (num_pages, page_size, 2 * n_kv_heads, head_dim)
    ).astype(dtype)
    perm = rng.permutation(np.arange(1, num_pages))
    page_indices = np.zeros((S, maxp), np.int32)
    used = 0
    for i, k in enumerate(kv_lens):
        n = -(-k // page_size)
        page_indices[i, :n] = perm[used : used + n]
        used += n
    kv = np.zeros(S, np.int32)
    kv[:n_real] = kv_lens
    cu = np.zeros(S + 1, np.int32)
    cu[1 : n_real + 1] = np.cumsum(q_lens)
    cu[n_real + 1 :] = cu[n_real]
    return dict(
        q=q, kv_pages=kv_pages, kv_lens=kv, page_indices=page_indices,
        cu_q_lens=cu, num_seqs=np.array([n_real], np.int32),
    )


def latent_batch(rng, *, q_lens, kv_lens, S, T, n_heads, latent_dim, page_size=16):
    """Random inputs of MLA paged attention over a K-only latent cache, as
    numpy arrays: q [T, H, Dc], k_pages [P, page_size, 1, Dc] and the
    ragged-batch index arrays of ragged_batch (same padding conventions)."""
    out = ragged_batch(rng, q_lens=q_lens, kv_lens=kv_lens, S=S, T=T, n_heads=n_heads,
                       n_kv_heads=1, head_dim=latent_dim, page_size=page_size,
                       num_pages=1 + sum(-(-k // page_size) for k in kv_lens))
    kv = out.pop("kv_pages")
    out["k_pages"] = np.ascontiguousarray(kv[:, :, :1])  # the K rows only
    return out


# ------------------------------------------------------- quantized checkpoints


def _pack_nibbles(u, axis, order=tuple(range(8))):
    """Unsigned nibbles -> int32 words of 8 along `axis`, nibble i of a word
    taken from offset order[i] of its run of 8."""
    u = np.moveaxis(u, axis, -1).astype(np.uint32)
    out = np.zeros(u.shape[:-1] + (u.shape[-1] // 8,), np.uint32)
    for i in range(8):
        out |= (u[..., order[i]::8] & 0xF) << np.uint32(4 * i)
    return np.ascontiguousarray(np.moveaxis(out.view(np.int32), -1, axis))


AWQ_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
PROJECTIONS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def quantize_checkpoint(src_dir, dst_dir, fmt, group=32, desc_act=False, seed=7,
                        quant_method=None):
    """An AWQ or GPTQ int4 checkpoint made from a float Llama checkpoint, as
    AutoAWQ / AutoGPTQ serialize them: qweight and qzeros packed into int32,
    f16 scales, g_idx under desc_act (rows quantized in a random activation
    order). GPTQ is symmetric (zero point 8); AWQ is asymmetric, with a zero
    point per group and column. Returns dst_dir."""
    import json
    import os
    import shutil

    from safetensors import safe_open
    from safetensors.numpy import save_file

    os.makedirs(dst_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    src = [f for f in os.listdir(src_dir) if f.endswith(".safetensors")][0]
    out = {}
    with safe_open(os.path.join(src_dir, src), framework="numpy") as f:
        for name in f.keys():
            t = f.get_tensor(name)
            if not name.endswith(tuple(p + ".weight" for p in PROJECTIONS)):
                out[name] = t
                continue
            w = np.ascontiguousarray(t.T.astype(np.float32))  # [in, out]
            K, N = w.shape
            if desc_act:
                act_order = rng.permutation(K)
                g_idx = np.empty(K, np.int32)
                g_idx[act_order] = np.arange(K, dtype=np.int32) // group
                w = w[act_order]
            g = w.reshape(K // group, group, N)
            if fmt == "awq":
                lo, hi = g.min(axis=1), g.max(axis=1)
                scales = (np.maximum(hi - lo, 1e-5) / 15.0).astype(np.float16)
                s = scales.astype(np.float32)
                zp = np.clip(np.round(-lo / s), 0, 15)
                u = np.clip(np.round(g / s[:, None, :]) + zp[:, None, :], 0, 15)
            else:
                scales = (np.maximum(np.abs(g).max(axis=1), 1e-5) / 7.0).astype(np.float16)
                zp = np.full(scales.shape, 8.0)
                u = np.clip(np.round(g / scales.astype(np.float32)[:, None, :]) + 8, 0, 15)
            u = u.reshape(K, N).astype(np.uint8)
            if desc_act:
                u_orig = np.empty_like(u)
                u_orig[act_order] = u  # rows back in checkpoint order
                u = u_orig
            stem = name[: -len(".weight")]
            if fmt == "awq":
                out[stem + ".qweight"] = _pack_nibbles(u, 1, AWQ_ORDER)
                out[stem + ".qzeros"] = _pack_nibbles(zp.astype(np.uint8), 1, AWQ_ORDER)
            else:
                out[stem + ".qweight"] = _pack_nibbles(u, 0)
                out[stem + ".qzeros"] = _pack_nibbles((zp - 1).astype(np.uint8), 1)  # GPTQ stores z - 1
                if desc_act:
                    out[stem + ".g_idx"] = g_idx
            out[stem + ".scales"] = scales
    save_file(out, os.path.join(dst_dir, "model.safetensors"))
    with open(os.path.join(src_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["quantization_config"] = {
        "quant_method": quant_method or fmt, "bits": 4, "group_size": group,
        "zero_point": fmt == "awq", "sym": True, "desc_act": desc_act,
    }
    with open(os.path.join(dst_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    for extra in ("tokenizer.json", "generation_config.json"):
        if os.path.exists(os.path.join(src_dir, extra)):
            shutil.copy(os.path.join(src_dir, extra), os.path.join(dst_dir, extra))
    return dst_dir


# ------------------------------------------------------- shared checkpoints


def shared_checkpoint(name: str, build) -> str:
    """A checkpoint directory built once per temp directory and shared by
    every test process that asks for `name`: the first caller runs
    build(dirpath) under a file lock (later callers wait for it, then reuse
    the result) and the finished directory is renamed into place, so no
    caller sees half of it. The name carries everything the build depends
    on. A caller waits for another's build at most LOCK_LIMIT_S, then
    fails."""
    import fcntl
    import os
    import shutil
    import tempfile
    import time

    root = os.path.join(tempfile.gettempdir(), "scalellm_torch_port_checkpoints")
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, name)
    if os.path.isdir(final):
        return final
    with open(final + ".lock", "w") as lock:
        # The lock, waited for at most LOCK_LIMIT_S: a build that another
        # process never finishes fails here instead of holding the run.
        deadline = time.monotonic() + LOCK_LIMIT_S
        while True:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except BlockingIOError:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{name}: another process held the build lock for {LOCK_LIMIT_S} s")
                time.sleep(0.5)
        if not os.path.isdir(final):
            tmp = f"{final}.building-{os.getpid()}"
            shutil.rmtree(tmp, ignore_errors=True)
            build(tmp)
            os.replace(tmp, final)
    return final


def tiny_llama(hidden_size: int = 64) -> str:
    """tests/fixtures.make_tiny_llama's float32 checkpoint (seed 0, the char
    tokenizer) at this hidden size and twice it as the FFN width, built
    once for every file that uses it: the transformers import it needs is
    the slowest part of these files' set-up."""
    import tests.fixtures as fixtures

    return shared_checkpoint(
        f"tiny_llama_h{hidden_size}_f{2 * hidden_size}_seed0_tok",
        lambda d: fixtures.make_tiny_llama(d, tokenizer=True, hidden_size=hidden_size,
                                           intermediate_size=2 * hidden_size))


# ------------------------------------------------------- LoRA adapters

LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def lora_dims(args) -> dict:
    """target -> (K, N) of a model's projections, from its ModelArgs (either
    package's)."""
    q_n, kv_n = args.n_heads * args.head_dim, args.n_kv_heads * args.head_dim
    D, F = args.hidden_size, args.intermediate_size
    return {"q_proj": (D, q_n), "k_proj": (D, kv_n), "v_proj": (D, kv_n), "o_proj": (q_n, D),
            "gate_proj": (D, F), "up_proj": (D, F), "down_proj": (F, D)}


def make_lora_adapter(dirpath, dims, n_layers, r=4, alpha=8, seed=0, targets=LORA_TARGETS, scale=0.02,
                      extra=None, config=None):
    """A random LoRA adapter in the HF PEFT layout (tests/test_lora.py's
    _make_adapter) at the widths `dims` (lora_dims): adapter_model.safetensors
    with A [r, K] and B [N, r] f32 for every layer and target, and
    adapter_config.json. `extra` adds tensors as they are, `config` updates
    the config (the loader's refusals). Returns ({(layer, target): (A, B)},
    alpha / r)."""
    import json
    import os

    from safetensors.numpy import save_file

    rng = np.random.RandomState(seed)
    tensors, mats = {}, {}
    for layer in range(n_layers):
        for t in targets:
            K, N = dims[t]
            A = (rng.randn(r, K) * scale).astype(np.float32)
            B = (rng.randn(N, r) * scale).astype(np.float32)
            grp = "self_attn" if t in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
            prefix = f"base_model.model.model.layers.{layer}.{grp}.{t}"
            tensors[f"{prefix}.lora_A.weight"] = A
            tensors[f"{prefix}.lora_B.weight"] = B
            mats[(layer, t)] = (A, B)
    tensors.update(extra or {})
    os.makedirs(dirpath, exist_ok=True)
    save_file(tensors, os.path.join(dirpath, "adapter_model.safetensors"))
    with open(os.path.join(dirpath, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": alpha, "target_modules": list(targets),
                   **(config or {})}, f)
    return mats, alpha / r


def merge_lora(dirpath, base_dir, mats, scaling):
    """A dense Llama checkpoint with the adapter folded into its weights
    offline (W + B A alpha / r, in the checkpoint's type): tests/test_lora.py's
    _make_merged."""
    import os
    import shutil

    from safetensors.numpy import load_file, save_file

    os.makedirs(dirpath, exist_ok=True)
    for name in os.listdir(base_dir):
        if not name.endswith(".safetensors"):
            shutil.copy(os.path.join(base_dir, name), os.path.join(dirpath, name))
    src = [f for f in os.listdir(base_dir) if f.endswith(".safetensors")]
    assert len(src) == 1
    weights = dict(load_file(os.path.join(base_dir, src[0])))
    for (layer, t), (A, B) in mats.items():
        grp = "self_attn" if t in ("q_proj", "k_proj", "v_proj", "o_proj") else "mlp"
        key = f"model.layers.{layer}.{grp}.{t}.weight"
        w = weights[key].astype(np.float32)  # torch layout [N, K]
        weights[key] = (w + (B @ A) * scaling).astype(weights[key].dtype)
    save_file(weights, os.path.join(dirpath, src[0]))
    return dirpath


# ------------------------------------------------------- bounded waits

GENERATE_LIMIT_S = 300
LOCK_LIMIT_S = 600


def generate_within(llm, *args, seconds=GENERATE_LIMIT_S, **kw):
    """llm.generate(*args, **kw) (either package's LLM) on a daemon thread,
    waited for at most `seconds`: a serve that never returns (a request that
    never finishes, a handling thread that died) fails the test instead of
    holding the whole run."""
    import threading

    import pytest

    out, err = [], []

    def run():
        try:
            out.append(llm.generate(*args, **kw))
        except BaseException as e:  # re-raised on the test's thread
            err.append(e)

    t = threading.Thread(target=run, name="generate-within", daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"LLM.generate did not return within {seconds} s")
    if err:
        raise err[0]
    return out[0]


def trained_tiny_llama() -> str:
    """tests/fixtures.make_trained_tiny_llama (250 steps, seed 0, hidden 128,
    the char tokenizer), built once for every port test process."""
    import tests.fixtures as fixtures

    return shared_checkpoint("trained_tiny_llama_s250_seed0_1thread", fixtures.make_trained_tiny_llama)


# ------------------------------------------------------- server processes

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]
SERVER_READY_S = 120


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(module: str, *args: str):
    """`python -m module args` from the repository root, with one intra-op
    thread (OMP_NUM_THREADS=1) and JAX on the CPU, its output in a
    temporary file (a pipe nobody reads could fill and block it; output()
    reads the file)."""
    import os
    import subprocess
    import sys
    import tempfile

    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen([sys.executable, "-m", module, *args], env=env, cwd=str(REPO), stdout=log,
                            stderr=subprocess.STDOUT)
    proc.log = log
    return proc


def output(proc) -> str:
    """What a process of spawn() has written so far."""
    proc.log.seek(0)
    return proc.log.read().decode(errors="replace")


def wait_ready(procs, ready, what: str, seconds: float = SERVER_READY_S) -> None:
    """Poll ready() (True once the server answers) until `seconds` pass;
    fails if one of `procs` exits first, with its output."""
    import time

    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for proc in procs:
            if proc.poll() is not None:
                raise RuntimeError(f"{what}: a process exited with {proc.returncode}:\n{output(proc)}")
        try:
            if ready():
                return
        except Exception:
            pass
        time.sleep(0.25)
    raise RuntimeError(f"{what} not ready within {seconds} s")


def http_ok(url: str) -> bool:
    import urllib.request

    with urllib.request.urlopen(url, timeout=2) as r:
        return r.status == 200


def stop_all(procs, seconds: float = 10) -> list:
    """SIGTERM each process, kill it after `seconds`; their return codes."""
    import subprocess

    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    codes = []
    for proc in procs:
        try:
            codes.append(proc.wait(timeout=seconds))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes.append(proc.wait())
    return codes
