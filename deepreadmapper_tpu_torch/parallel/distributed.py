"""Multi-process set-up and per-process index-shard orchestration on
``torch.distributed``.

Counterpart of ``deepreadmapper_tpu/parallel/distributed.py``.  The
deployment model is the JAX package's:

  * ``init_distributed(backend)`` on every process (torchrun's environment
    gives the rank, the world size and the rendezvous); each rank computes
    on ``cuda:LOCAL_RANK``.
  * The genome's codes / vectors split row-wise into shards.  Each process
    owns a contiguous block of shards (``own_shards``), embeds ONLY their
    window ranges (``plan_shards``), and persists them with
    ``build_own_shards``; rank 0 writes the manifest.  ``load_own_shards``
    restores just the process-local sub-indexes.
  * A search runs the same query batch on every rank: each rank searches
    its own shards, one all_gather exchanges the per-shard top-k, and every
    rank merges (``sharded_ann.ShardedANNIndex.load_distributed``).

The shard files are byte-compatible with the single-process
``ShardedANNIndex.build(...).save(...)``: both pad the tail shard by
repeating the final row, and both mask pad rows at merge time by the
manifest's ntotal.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from deepreadmapper_tpu_torch.config import BuildConfig

_BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, device=None, init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None
                     ) -> torch.device:
    """Join this process's group; returns the device the rank computes on.

    backend is the caller's choice, never guessed: "nccl" for card tensors,
    "gloo" for CPU tensors (the collectives then cross the host; NCCL also
    refuses two ranks on one card, gloo does not).  The rank, the world
    size and the rendezvous come from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) unless init_method
    (e.g. "tcp://localhost:29500"), world_size and rank are given.  With
    neither, this is a one-process run and no group is made.  A group that
    was asked for and fails to initialise raises.

    device defaults to ``cuda:LOCAL_RANK`` (raises without a card, like
    every entry point of the port); pass "cpu" or another device to choose."""
    from deepreadmapper_tpu_torch import default_device

    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if device is None:
        default_device()
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    asked = (init_method is not None or world_size is not None
             or "WORLD_SIZE" in os.environ)
    if not asked:
        return device
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is already "
                               f"initialised; asked for {backend}")
        return device
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size if world_size is not None else -1,
                            rank=rank if rank is not None else -1)
    return device


def world_size() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    """True on the rank that writes output files (rank 0)."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op in a one-process run)."""
    if world_size() > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where the group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_cat(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's t (one shape on all ranks) concatenated along dim in
    rank order, on t's device."""
    if world_size() == 1:
        return t
    x = t.contiguous().to(_comm_device())
    out = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(out, x)
    return torch.cat(out, dim=dim).to(t.device)


def all_reduce_sum_(tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place: one all_reduce of one flat
    buffer on the collectives' device (the CPU under gloo, so gloo ranks
    may hold card tensors).  Every rank receives the same bytes."""
    if world_size() == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).to(_comm_device())
    dist.all_reduce(flat)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view(t.shape))
        off += n


def global_max(v: int) -> int:
    """The largest of an integer across the ranks."""
    if world_size() == 1:
        return int(v)
    t = torch.tensor([int(v)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def all_gather_object(obj) -> list:
    """Every rank's picklable obj, in rank order."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


# Copied from deepreadmapper_tpu/parallel/distributed.py (that module imports jax).
def plan_shards(n_vectors: int, n_shards: int) -> list[tuple[int, int]]:
    """Row ranges per shard, padded so every shard holds the same count;
    the pad rows are masked by id bound.  Ranges clamp to [0, n_vectors] --
    the ceil split can leave tail shards empty (n=5, shards=4 -> per=2 ->
    shard 3 owns nothing)."""
    per = -(-n_vectors // n_shards)
    return [
        (min(s * per, n_vectors), min((s + 1) * per, n_vectors))
        for s in range(n_shards)
    ]


def own_shards(n_shards: int, process_id: int | None = None,
               num_processes: int | None = None) -> list[int]:
    """Shard indices THIS process owns: contiguous blocks, so a process's
    shards cover a contiguous window range of the genome.  Any process count
    that divides n_shards works -- 1 process owns everything, n_shards
    processes own one each."""
    pid = rank() if process_id is None else process_id
    nproc = world_size() if num_processes is None else num_processes
    if n_shards % nproc:
        raise ValueError(
            f"n_shards={n_shards} must be divisible by the process count "
            f"{nproc} so every host owns whole shards"
        )
    per = n_shards // nproc
    return list(range(pid * per, (pid + 1) * per))


def build_own_shards(
    embed_rows,
    n_vectors: int,
    n_shards: int,
    index_prefix: str,
    cfg: BuildConfig | None = None,
    index_type: str = "INT8FLAT",
    process_id: int | None = None,
    num_processes: int | None = None,
    codes_scale: float | None = None,
    device=None,
) -> list[int]:
    """Encode and persist ONLY this process's shards.

    embed_rows(start, end) -> [end-start, D] produces the rows of a global
    range (wired to the windowed-FASTA embedder, so a process never touches
    another's genome slice): fp32 embeddings, or int8 CODES at codes_scale
    (INT8FLAT / IVFINT8: the quantized rows leave the card at 128 B each).
    Every shard directory is self-contained, so the build needs no
    collective; rank 0 also writes sharded.txt.  Returns the shard ids this
    process built."""
    from deepreadmapper_tpu_torch import resolve_device
    from deepreadmapper_tpu_torch.index.registry import engine_class
    from deepreadmapper_tpu_torch.parallel.sharded_ann import build_engine

    cfg = cfg or BuildConfig()
    device = resolve_device(device)
    ranges = plan_shards(n_vectors, n_shards)
    per = ranges[0][1] - ranges[0][0]
    if per >= 2**31:
        raise NotImplementedError(
            f"{per} rows/shard exceeds the int32 local-id space; use more shards"
        )
    if codes_scale is not None and index_type not in ("INT8FLAT", "IVFINT8"):
        raise ValueError(
            f"codes_scale applies to the int8-coded engines; got {index_type}"
        )
    eng = engine_class(index_type)
    mine = own_shards(n_shards, process_id, num_processes)
    os.makedirs(index_prefix, exist_ok=True)
    for si in mine:
        start, end = ranges[si]
        emb = np.asarray(embed_rows(start, end))
        if emb.shape[0] != end - start:
            raise ValueError(f"embed_rows({start},{end}) returned {emb.shape[0]} rows")
        if emb.shape[0] < per:
            # tail shard: repeat the last real row (an empty tail shard pads
            # with the GLOBAL last row -- ShardedANNIndex.build's convention)
            pad_src = (emb[-1:] if emb.shape[0]
                       else np.asarray(embed_rows(n_vectors - 1, n_vectors)))
            emb = np.concatenate([emb, np.repeat(pad_src, per - emb.shape[0], axis=0)])
        if codes_scale is not None:
            codes = np.asarray(emb, np.int8)
            if index_type == "INT8FLAT":
                sub = eng(codes, codes_scale, codes.shape[0], device)
            else:
                sub = eng.build_from_codes(codes, codes_scale, cfg, device=device)
        else:
            sub = build_engine(index_type, emb, cfg, device)
        sub.save(os.path.join(index_prefix, f"shard_{si}"))
    pid = rank() if process_id is None else process_id
    if pid == 0:
        with open(os.path.join(index_prefix, "sharded.txt"), "w") as f:
            f.write(f"n_shard:{n_shards}\n")
            f.write(f"ntotal:{n_vectors}\n")
            f.write(f"inner:{index_type}\n")
    return mine


def load_own_shards(index_prefix: str, process_id: int | None = None,
                    num_processes: int | None = None, device=None):
    """Load ONLY this process's sub-indexes from a sharded index directory.

    Returns (subs, shard_ids, manifest).  A process restoring a 16-shard
    index with 4 processes loads 4 sub-indexes and never reads another
    process's codes.  A one-process caller gets every shard."""
    from deepreadmapper_tpu_torch import resolve_device
    from deepreadmapper_tpu_torch.index.registry import engine_class
    from deepreadmapper_tpu_torch.parallel.sharded_ann import read_manifest

    device = resolve_device(device)
    meta = read_manifest(index_prefix)
    mine = own_shards(int(meta["n_shard"]), process_id, num_processes)
    eng = engine_class(meta["inner"])
    subs = [eng.load(os.path.join(index_prefix, f"shard_{si}"), device=device)
            for si in mine]
    return subs, mine, meta
