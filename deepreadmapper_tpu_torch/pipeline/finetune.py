"""Encoder fine-tuning: sampled (read, source-window) pairs -> InfoNCE steps.

Counterpart of ``deepreadmapper_tpu/pipeline/finetune.py``.  Pairs are drawn
from a reference genome on the host (windows of either strand, reads
simulated from them with substitution, shift and indel noise); each step
runs ``parallel.train.train_step`` on the device, on this rank's slice of
the global batch when a ``torch.distributed`` group is up.  The result is a
params
dict of fp32 numpy arrays (the layout of ``models.encoder.load_params``),
and :func:`save_params_npz` writes it in the IR-layout fp16 npz that both
packages' ``load_params`` read, and that ``build-index --weights`` takes.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from deepreadmapper_tpu_torch import resolve_device
from deepreadmapper_tpu_torch import tokenizer as tok
from deepreadmapper_tpu_torch.io import fasta as fasta_io
from deepreadmapper_tpu_torch.models import encoder as enc
from deepreadmapper_tpu_torch.parallel import distributed as dist_
from deepreadmapper_tpu_torch.parallel.train import make_optimizer, train_step


# Copied from deepreadmapper_tpu/pipeline/finetune.py (that module imports jax).
def _indel_augment(
    mat: np.ndarray,
    lens: np.ndarray,
    rng: np.random.Generator,
    rate: float,
    width: int,
    ref_len: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Apply random single-base insertions and deletions (each at `rate`
    per base) to the BASE region of wrapped read rows; the '<'/'>' wrap
    bytes are never mutated.  Rows were fetched with slack columns so
    deletions still fill `width`.

    Length semantics match real wrapped reads: out_lens is the TRUE
    (pre-truncation) wrapped length, adjusted by the net indel count, so the
    tokenizer's end-of-sequence handling fires exactly when it would for a
    served read of the same length (a truncated 150 bp read never produces
    a suffix-class final token; a short read does)."""
    w_in = mat.shape[1]
    base_n = min(ref_len, w_in - 1)  # base columns: [1, 1+base_n); '>' later
    out = np.zeros((mat.shape[0], width), dtype=mat.dtype)
    out_lens = np.empty_like(lens)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    for i in range(mat.shape[0]):
        body = mat[i, 1 : 1 + base_n]
        keep = rng.random(body.size) >= rate
        kept = body[keep]
        n_del = base_n - kept.size
        n_ins = int(rng.binomial(kept.size, rate))
        if n_ins:
            pos = np.sort(rng.integers(0, kept.size + 1, n_ins))
            kept = np.insert(kept, pos, acgt[rng.integers(0, 4, n_ins)])
        n = min(kept.size, width - 1)
        out[i, 0] = mat[i, 0]
        out[i, 1 : 1 + n] = kept[:n]
        true_len = max(2, int(lens[i]) + n_ins - n_del)
        if true_len <= width:  # short read: the terminator is materialized
            out[i, true_len - 1] = ord(">")
        out_lens[i] = true_len
    return out, out_lens


# Copied from deepreadmapper_tpu/pipeline/finetune.py (that module imports jax).
def sample_pairs(
    genome: np.ndarray,
    ref_len: int,
    batch: int,
    rng: np.random.Generator,
    sub_rate: float = 0.01,
    max_len: int = 123,
    max_shift: int = 0,
    indel_rate: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (read_tokens, window_tokens) int32 [batch, max_len]: random
    genome windows (either strand) and noisy simulated reads from them.

    max_shift > 0 additionally offsets each read's start by 0..max_shift
    bases from its window (shift-matched training for SPARSE serving: with
    stride s, real reads start up to s-1 bases off the nearest indexed
    window, a mismatch substitution noise alone never teaches — measured to
    cap sparse top-1 at genome scale regardless of candidate count).

    indel_rate > 0 additionally applies single-base insertions and
    deletions (each at that per-base rate) to the read — long-read error
    profiles (PacBio/ONT) are indel-dominated, and an indel shifts every
    downstream 3-mer the same way a start-offset does.
    """
    glen = genome.size
    pos = rng.integers(0, glen - ref_len + 1, size=batch)
    strand = rng.integers(0, 2, size=batch)
    ids = (pos << 1) | strand
    w_mat, w_lens = fasta_io.fetch_windows_by_id(genome, ids, ref_len, max_len, wrap=True)
    fetch_len = max_len + 8 if indel_rate > 0 else max_len  # deletion slack
    if max_shift > 0:
        delta = rng.integers(0, max_shift + 1, size=batch)
        pos_r = np.clip(pos + delta, 0, glen - ref_len)
        r_ids = (pos_r << 1) | strand
        r_mat, r_lens = fasta_io.fetch_windows_by_id(
            genome, r_ids, ref_len, fetch_len, wrap=True
        )
    elif indel_rate > 0:
        r_mat, r_lens = fasta_io.fetch_windows_by_id(
            genome, ids, ref_len, fetch_len, wrap=True
        )
    else:
        r_mat, r_lens = w_mat.copy(), w_lens
    # Substitution noise in the read body — BEFORE indels, so the slice
    # [1, ref_len+1) only ever contains bases (after augmentation a short
    # read's '>' terminator can move inside that range).
    body = r_mat[:, 1 : min(ref_len + 1, r_mat.shape[1])]
    noise = rng.random(body.shape) < sub_rate
    subs = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=body.shape)]
    r_mat[:, 1 : 1 + body.shape[1]] = np.where(noise, subs, body)
    if indel_rate > 0:
        # rows are max_len+1 wide like every fetched byte matrix (the
        # tokenizer reads max_len+1 columns; one narrower and the final
        # 3-mer hashes a padding byte)
        r_mat, r_lens = _indel_augment(
            r_mat, r_lens, rng, indel_rate, max_len + 1, ref_len
        )
    rt = tok.tokenize_bytes_fast(r_mat, r_lens, max_len)
    wt = tok.tokenize_bytes_fast(w_mat, w_lens, max_len)
    return rt, wt


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host tokens -> device.  On a card the copy goes through pinned
    memory without waiting, so sampling the next batch on the host overlaps
    the device's work on this one."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def finetune(
    ref_file: str,
    ref_len: int,
    steps: int = 100,
    batch: int = 512,
    lr: float = 1e-4,
    seed: int = 0,
    params: dict | None = None,
    sub_rate: float = 0.01,
    max_shift: int = 0,
    indel_rate: float = 0.0,
    state_path: str | None = None,
    device: torch.device | str | None = None,
) -> tuple[dict, list[float]]:
    """Run fine-tuning; returns (params, per-step losses).  params defaults
    to the shipped weights; device to the card (raises without one).

    state_path: when given, the full training state (params, Adam moments
    and step, step counter, data-rng position) is loaded from it if it
    exists and saved back after training: exact resume, unlike the
    weights-only npz.

    Under a ``torch.distributed`` group, the port's counterpart of the JAX
    package's mesh, training is data-parallel: batch is the GLOBAL batch
    and must divide by the world size.  Every rank draws the whole batch
    from the same rng, so the data stream and the state file are the JAX
    package's, and trains on its contiguous slice; the losses are the
    global batch's.  Every rank reads an existing state; rank 0 alone
    writes it."""
    device = resolve_device(device)
    world, rank = dist_.world_size(), dist_.rank()
    if batch % world:
        raise ValueError(f"batch {batch} must divide by the world size {world}: "
                         "each rank trains on an equal slice of the global batch")
    per = batch // world
    rows = slice(rank * per, (rank + 1) * per)
    genome = fasta_io.extract_fasta_sequence(ref_file)
    tparams = enc.torch_params(params if params is not None else enc.load_params(),
                               device, requires_grad=True)
    opt = make_optimizer(tparams, lr)
    step_done = 0
    rng = np.random.default_rng(seed)
    if state_path is not None:
        # np.savez appends .npz to extensionless paths: normalise up front
        # so the resume check and the save agree.
        if not state_path.endswith(".npz"):
            state_path += ".npz"
        d = os.path.dirname(state_path)
        if d:
            os.makedirs(d, exist_ok=True)
        if os.path.exists(state_path):
            tparams, opt, step_done, rng = load_train_state(state_path, lr, device)
            if rank == 0:
                print(f"[FINETUNE] resumed from {state_path} at step {step_done}")
        elif rank == 0:
            print(f"[FINETUNE] no state at {state_path}, starting fresh")
    losses = []
    for _ in range(steps):
        rt, wt = sample_pairs(
            genome, ref_len, batch, rng, sub_rate=sub_rate,
            max_shift=max_shift, indel_rate=indel_rate,
        )
        losses.append(train_step(tparams, opt, _upload(rt[rows], device),
                                 _upload(wt[rows], device)))
    losses = torch.stack(losses).tolist() if losses else []
    if state_path is not None:
        if rank == 0:
            save_train_state(state_path, tparams, opt, step_done + steps, rng)
        dist_.barrier()
    return enc.numpy_params(tparams), losses


def save_train_state(path: str, params: dict, opt: torch.optim.Optimizer,
                     step: int, rng: np.random.Generator) -> None:
    """Full training-state checkpoint in one npz: each param leaf by name,
    its Adam moments as ``adam_m.<name>`` / ``adam_v.<name>``, Adam's step,
    the step counter and the numpy generator's state (JSON bytes)."""
    payload = {}
    adam_step = 0.0
    for name, p in enc.named_leaves(params):
        payload[name] = p.detach().cpu().numpy()
        st = opt.state.get(p)
        if st:
            payload["adam_m." + name] = st["exp_avg"].cpu().numpy()
            payload["adam_v." + name] = st["exp_avg_sq"].cpu().numpy()
            adam_step = float(st["step"])
    payload["adam_step"] = np.float64(adam_step)
    payload["step"] = np.int64(step)
    payload["rng_state"] = np.frombuffer(
        json.dumps(rng.bit_generator.state).encode(), dtype=np.uint8)
    if not path.endswith(".npz"):
        path += ".npz"
    # Atomic replace: a crash mid-save must not corrupt the only checkpoint.
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_train_state(path: str, lr: float = 1e-4, device=None):
    """Inverse of save_train_state -> (params, optimizer, step, rng); the
    params are leaf tensors on device that require grad."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = enc.torch_params(enc.params_from_named(arrays), device, requires_grad=True)
    names = [name for name, _ in enc.named_leaves(params)]
    opt = make_optimizer(params, lr)
    if arrays["adam_step"] > 0:
        sd = opt.state_dict()
        sd["state"] = {
            i: {"step": torch.tensor(float(arrays["adam_step"])),
                "exp_avg": torch.from_numpy(arrays["adam_m." + name]),
                "exp_avg_sq": torch.from_numpy(arrays["adam_v." + name])}
            for i, name in enumerate(names)
        }
        opt.load_state_dict(sd)
    rng = np.random.default_rng()
    rng.bit_generator.state = json.loads(arrays["rng_state"].tobytes().decode())
    return params, opt, int(arrays["step"]), rng


def save_params_npz(params: dict, path: str) -> None:
    """Persist weights (a params dict of arrays or tensors) in the IR-layout
    fp16 npz that both packages' ``models.encoder.load_params`` read."""
    p = enc.numpy_params(params)

    def unpack(lp):
        w = np.swapaxes(lp["w"], 1, 2)
        r = np.swapaxes(lp["r"], 1, 2)
        b = np.concatenate([lp["bzr"][:, :128], lp["bzr"][:, 128:192], lp["rbh"]], axis=1)
        return w, r, b

    w1, r1, b1 = unpack(p["layers"][0])
    w2, r2, b2 = unpack(p["layers"][1])
    np.savez_compressed(
        path,
        embedding=p["embedding"].astype(np.float16),
        gru1_W=w1.astype(np.float16),
        gru1_R=r1.astype(np.float16),
        gru1_B=b1.astype(np.float16),
        gru2_W=w2.astype(np.float16),
        gru2_R=r2.astype(np.float16),
        gru2_B=b2.astype(np.float16),
    )
