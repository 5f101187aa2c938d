"""Distributed engine: rank-0 scheduling over the ranks of tensor
parallelism (counterpart of scalellm_tpu/engine/distributed.py, over
torch.distributed).

In the reference the model's mesh spans hosts and every host must enter the
same jitted program on the same inputs. Here tensor parallelism is one
process a rank even on one host (torch has no shard_map: the model calls
collectives between processes, parallel/collectives.py), so this
single-controller pattern is how tensor parallelism runs at all:

  rank 0 (driver):    the handler, scheduler and batch building; each step
                      broadcasts (header, step inputs) to the followers,
                      then runs the step itself.
  ranks 1..N-1 (followers): run_follower() — receive the step inputs and run
                      the same step; their slices join through the model's
                      collectives.

The broadcast is two-phase because a broadcast needs the same shapes on
every rank: a fixed 9-slot header carries the padded bucket dims (and the
step counter that catches a desync), then the followers allocate matching
placeholders (_placeholders: the guided-decoding mask and the seeds
included) for the arrays' broadcast. Every kind of step the driver runs,
the followers run too; a step kind they cannot follow (prompt scoring, the
async and multi-step dispatches) is refused, never run on the driver alone,
where it would hang the next collective.

launch() starts a world on one machine: the calling process is rank 0, and
it starts the N-1 followers itself (the spawn start method; each on its own
device). The backend follows from the devices (backend_for): "nccl" when
each rank has a card of its own, "gloo" on the CPU and where ranks share a
card. close() sends the stop header, joins the followers and checks their
exit codes. A follower that dies makes the driver's next step raise: its
process's exit code is checked before each step, and a collective with a
dead peer fails with gloo's connection error (at the latest after
parallel/multihost.py's COLLECTIVE_TIMEOUT_S). Processes started by other
means (api_server's --coordinator on each host) join with
multihost.init_distributed and build the engine with the mesh of the world.

Beyond the reference: rank_launches() reads every rank's kernel launch
counts (ops.kernel_counters; a _COUNTS header, then a gather to the driver),
so that the driver can see that each rank ran the kernels.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing
import socket
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from scalellm_tpu_torch.engine.batch import Batch
from scalellm_tpu_torch.engine.executor import HostOutputs
from scalellm_tpu_torch.engine.llm_engine import EngineOptions, LLMEngine
from scalellm_tpu_torch.engine.params import ModelInputs, SamplingInputs
from scalellm_tpu_torch.parallel import multihost

logger = logging.getLogger(__name__)

# header: [running_flag, T, S, MAXP, U, B(logit-bias width), decode_only,
#          W(guided-mask width), step_counter]
_HEADER_LEN = 9
_STOP = -1
_HEARTBEAT = 2
# header[1]: whether each rank resets its counts after reading them.
_COUNTS = 3
# How long close() waits for a follower to exit after the stop header.
JOIN_TIMEOUT_S = 60.0


def _header_of(
    mi: ModelInputs,
    si: SamplingInputs,
    decode_only: bool = False,
    step: int = 0,
) -> np.ndarray:
    h = np.zeros(_HEADER_LEN, np.int32)
    h[0] = 1
    h[1] = mi.token_ids.shape[0]
    h[2] = mi.kv_lens.shape[0]
    h[3] = mi.block_tables.shape[1]
    h[4] = si.unique_token_ids.shape[1]
    h[5] = si.bias_token_ids.shape[1]
    h[6] = int(decode_only)
    h[7] = si.allowed_mask.shape[1]
    # Lockstep check: followers verify the driver's step counter matches
    # their own count of received steps — a mismatch means a rank skipped or
    # double-entered a collective (desync => silent garbage or deadlock), so
    # fail LOUDLY instead. int32 wrap is harmless: both sides wrap alike.
    h[8] = step & 0x7FFFFFFF
    return h


def check_step_header(header: np.ndarray, expected_step: int) -> None:
    """Raise on driver/follower step-counter desync (see _header_of)."""
    got = int(header[8])
    want = expected_step & 0x7FFFFFFF
    if got != want:
        raise RuntimeError(
            f"multihost desync: driver is at step {got}, this follower "
            f"expected {want} — a broadcast was missed or duplicated; "
            "aborting before entering a mismatched collective"
        )


def _placeholders(h: np.ndarray) -> Tuple[ModelInputs, SamplingInputs]:
    T, S, MAXP, U = int(h[1]), int(h[2]), int(h[3]), int(h[4])
    B = max(int(h[5]), 1)
    mi = ModelInputs(
        token_ids=np.zeros(T, np.int32),
        positions=np.zeros(T, np.int32),
        token_seg=np.zeros(T, np.int32),
        new_kv_slot_ids=np.zeros(T, np.int32),
        block_tables=np.zeros((S, MAXP), np.int32),
        kv_lens=np.zeros(S, np.int32),
        cu_q_lens=np.zeros(S + 1, np.int32),
        num_seqs=np.zeros(1, np.int32),
        selected_idxes=np.zeros(S, np.int32),
        seq_mask=np.zeros(S, np.float32),
    )
    si = SamplingInputs(
        temperatures=np.zeros(S, np.float32),
        top_ks=np.zeros(S, np.int32),
        top_ps=np.zeros(S, np.float32),
        frequency_penalties=np.zeros(S, np.float32),
        presence_penalties=np.zeros(S, np.float32),
        repetition_penalties=np.zeros(S, np.float32),
        unique_token_ids=np.zeros((S, U), np.int32),
        unique_token_counts=np.zeros((S, U), np.int32),
        bias_token_ids=np.zeros((S, B), np.int32),
        bias_values=np.zeros((S, B), np.float32),
        allowed_mask=np.zeros((S, max(int(h[7]), 1)), np.uint32),
        seeds=np.zeros(S, np.uint32),
    )
    return mi, si


def _conform(mi: ModelInputs, si: SamplingInputs, h: np.ndarray) -> Tuple[ModelInputs, SamplingInputs]:
    """The driver's step arrays in exactly the placeholders' dtypes and
    shapes, so that both sides of the broadcast hold the same bytes."""
    out = []
    for real, ph in zip((mi, si), _placeholders(h)):
        out.append(dataclasses.replace(real, **{
            f.name: np.asarray(getattr(real, f.name), dtype=getattr(ph, f.name).dtype).reshape(
                getattr(ph, f.name).shape)
            for f in dataclasses.fields(ph) if isinstance(getattr(ph, f.name), np.ndarray)}))
    return out[0], out[1]


def rank_devices(devices: str, tp_size: int) -> List[str]:
    """Each rank's device for tp_size ranks: "auto" is cuda:0 ... cuda:N-1
    (RuntimeError where fewer cards are visible), "cpu" puts every rank on
    the CPU, and a comma list names each rank's device ("cuda:0,cuda:0":
    two ranks share one card)."""
    if devices == "auto":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp_size:
            raise RuntimeError(f"tp_size {tp_size} with devices='auto' needs {tp_size} cards, {n} visible "
                               "(devices='cuda:0,cuda:0' runs two ranks on one card)")
        return [f"cuda:{i}" for i in range(tp_size)]
    names = [d.strip() for d in devices.split(",")]
    if names == ["cpu"]:
        return ["cpu"] * tp_size
    if len(names) != tp_size:
        raise ValueError(f"devices {devices!r} names {len(names)} devices for tp_size {tp_size}: name one a rank")
    return names


def backend_for(devices: Sequence[str]) -> str:
    """"nccl" when every rank has a card of its own, "gloo" on the CPU and
    where ranks share a card (NCCL refuses two ranks on one device)."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on {sorted(kinds)}: all on the CPU or all on cards")
    cards = [d.index if d.index is not None else 0 for d in devs]
    return "nccl" if len(set(cards)) == len(cards) else "gloo"


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _read_launches(reset: bool) -> Dict[str, int]:
    """This rank's kernel launch counts by wrapper (ops.kernel_counters),
    then set to 0 where `reset`."""
    from scalellm_tpu_torch.ops import kernel_counters

    counters = kernel_counters()
    out = {name: c.launches for name, c in counters.items()}
    if reset:
        for c in counters.values():
            c.launches = 0
    return out


def run_follower_process(options: EngineOptions, coordinator: str, world: int, rank: int, backend: str,
                         threads: int = 0) -> None:
    """A spawned follower's main: join the world, build this rank's engine
    and follow the driver until its stop header. An exception ends the
    process with a nonzero exit code, which the driver reports."""
    if threads:
        torch.set_num_threads(threads)
    if torch.device(options.device).type == "cuda":
        torch.cuda.set_device(torch.device(options.device))
    multihost.init_distributed(coordinator, world, rank, backend)
    try:
        engine = DistributedLLMEngine(options, mesh=multihost.make_pod_mesh(tp=world, device=options.device))
        engine.run_follower()
    finally:
        multihost.shutdown_distributed()


class DistributedLLMEngine(LLMEngine):
    """LLMEngine whose execute_model broadcasts the step inputs to every rank
    before running the step. In a world of one process: exactly LLMEngine.
    """

    def __init__(self, options: EngineOptions, mesh=None, followers: Sequence = ()):
        if mesh is None and multihost.process_count() > 1:
            # A world the caller joined (api_server --coordinator): one tp group over every rank.
            mesh = multihost.make_pod_mesh(device=options.device)
        self._multi = mesh is not None and mesh.world_size > 1
        # Spawned followers (launch), ranks 1.. in order.
        self._followers = list(followers)
        self._bcast_counter = 0
        self._closed = False
        if self._multi:
            multihost.collective_smoke_test(mesh)
        super().__init__(options, mesh=mesh)
        if self._multi:
            logger.info("rank %d of %d: %s backend, device %s", mesh.rank, mesh.world_size, mesh.backend,
                        mesh.device)

    @classmethod
    def launch(cls, options: EngineOptions, devices: Sequence[str]) -> "DistributedLLMEngine":
        """A world of len(devices) ranks on this machine: this process is
        rank 0 on devices[0] and spawns a follower a rank on the others."""
        world = len(devices)
        backend = backend_for(devices)
        coordinator = f"127.0.0.1:{free_port()}"
        ctx = multiprocessing.get_context("spawn")
        followers = []
        try:
            for rank in range(1, world):
                p = ctx.Process(
                    target=run_follower_process, name=f"scalellm-tp-rank{rank}", daemon=True,
                    args=(dataclasses.replace(options, device=devices[rank]), coordinator, world, rank, backend,
                          torch.get_num_threads()))
                p.start()
                followers.append(p)
            logger.info("tensor parallelism over %d ranks (%s backend): devices %s", world, backend,
                        ", ".join(devices))
            multihost.init_distributed(coordinator, world, 0, backend)
            mesh = multihost.make_pod_mesh(tp=world, device=devices[0])
            return cls(dataclasses.replace(options, device=devices[0]), mesh=mesh, followers=followers)
        except BaseException:
            for p in followers:
                p.kill()
                p.join(JOIN_TIMEOUT_S)
            multihost.shutdown_distributed()
            raise

    # ---------------------------------------------------------------- driver

    @property
    def supports_async(self) -> bool:
        """Followers run whole steps only: no split dispatch under tp."""
        return not self._multi

    @property
    def supports_multi_step(self) -> bool:
        return not self._multi

    def _check_followers(self) -> None:
        for rank, p in enumerate(self._followers, start=1):
            if p.exitcode is not None:
                raise RuntimeError(f"follower rank {rank} ({p.name}) exited with code {p.exitcode}")

    def _broadcast_header(self, header: np.ndarray) -> None:
        self._check_followers()
        multihost.broadcast_step_inputs(header)

    def execute_model(self, batch: Batch) -> None:
        if not self._multi:
            return super().execute_model(batch)
        if not batch.entries:
            return
        assert multihost.is_driver(), "only rank 0 schedules batches"
        if batch.score_top_k is not None:
            raise NotImplementedError("prompt logprobs are not supported with tensor parallelism")
        mi, si, want_lp = self._prepare(batch)
        decode_only = batch.is_decode_only
        self._bcast_counter += 1
        header = _header_of(mi, si, decode_only, step=self._bcast_counter)
        self._broadcast_header(header)
        mi, si = multihost.broadcast_step_inputs(*_conform(mi, si, header))
        outs = self.executor.execute(mi, si, decode_only=decode_only)
        o = HostOutputs(outs, want_lp).wait()
        batch.process_sample_output(o["next_tokens"], o["logprobs"], o["top_ids"], o["top_logprobs"],
                                    self.tokenizer)

    def rank_launches(self, reset: bool = False) -> List[Dict[str, int]]:
        """Every rank's kernel launch counts (ops.kernel_counters), by rank;
        with `reset` each rank sets its counts to 0 after reading them. One
        process: this one's. Call it from the thread that steps the engine:
        broadcasts must stay in order."""
        if not self._multi:
            return [_read_launches(reset)]
        import torch.distributed as dist

        h = np.zeros(_HEADER_LEN, np.int32)
        h[0], h[1] = _COUNTS, int(reset)
        self._broadcast_header(h)
        out = [None] * self.mesh.world_size
        dist.gather_object(_read_launches(reset), out, dst=0, group=multihost.cpu_group())
        return out

    # ---------------------------------------------------------------- follower

    def run_follower(self, idle_timeout: float | None = None) -> None:
        """Non-driver ranks: receive step inputs forever and run each step in
        lockstep with the driver. Returns when the driver broadcasts the
        stop header (shutdown).

        idle_timeout (seconds, None = wait forever): maximum time to block
        waiting for the NEXT step's header. On timeout, raises RuntimeError
        so the rank exits loudly; the payload broadcast that follows an
        already-received header is never the waiting point, so only the
        header wait is guarded."""
        assert self._multi and not multihost.is_driver()
        step = 0
        while True:
            header = multihost.broadcast_with_timeout(
                np.zeros(_HEADER_LEN, np.int32), timeout=idle_timeout
            )
            if int(header[0]) == _STOP:
                return
            if int(header[0]) == _HEARTBEAT:
                continue  # idle keep-alive; not a step
            if int(header[0]) == _COUNTS:
                import torch.distributed as dist

                dist.gather_object(_read_launches(bool(header[1])), None, dst=0, group=multihost.cpu_group())
                continue
            step += 1
            check_step_header(header, step)
            mi, si = _placeholders(header)
            (mi, si) = multihost.broadcast_step_inputs(mi, si)
            self.executor.execute(mi, si, decode_only=bool(header[6]))

    def heartbeat(self) -> None:
        """Idle keep-alive for followers running with an idle_timeout.
        Must be called from the same (scheduler) thread as execute_model —
        broadcasts must stay totally ordered across ranks."""
        if not self._multi:
            return
        h = np.zeros(_HEADER_LEN, np.int32)
        h[0] = _HEARTBEAT
        self._broadcast_header(h)

    def shutdown_followers(self) -> None:
        if not self._multi:
            return
        h = np.zeros(_HEADER_LEN, np.int32)
        h[0] = _STOP
        multihost.broadcast_step_inputs(h)

    def close(self) -> None:
        """Driver: the stop header, then join the spawned followers and leave
        the world; RuntimeError if a follower exited with a nonzero code or
        did not exit within JOIN_TIMEOUT_S (it is killed then)."""
        if self._closed or not self._multi:
            self._closed = True
            return
        self._closed = True
        errors = []
        try:
            if all(p.exitcode is None for p in self._followers):
                self.shutdown_followers()
        except Exception as e:  # a follower already gone: report below
            errors.append(f"stop header: {e}")
        for rank, p in enumerate(self._followers, start=1):
            p.join(JOIN_TIMEOUT_S)
            if p.exitcode is None:
                p.kill()
                p.join(JOIN_TIMEOUT_S)
                errors.append(f"follower rank {rank} did not exit within {JOIN_TIMEOUT_S:.0f} s (killed)")
            elif p.exitcode != 0:
                errors.append(f"follower rank {rank} exited with code {p.exitcode}")
        if self._followers:
            multihost.shutdown_distributed()
        if errors:
            raise RuntimeError("; ".join(errors))
