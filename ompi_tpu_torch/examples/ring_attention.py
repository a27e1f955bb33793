"""Ring attention over rank-threads — the long-context /
sequence-parallel flagship (shard the sequence, rotate KV blocks
around the ring with ppermute, accumulate attention online).  The
port's copy of the reference's ``examples/ring_attention.py``, in
torch.

Each rank owns one sequence shard (Q_i, K_i, V_i).  The KV block
rotates size times via ``comm.ppermute_arr`` (the neighbour-shift
primitive: on one card, the hbm tier's copies); partial attention
accumulates with the online-softmax (log-sum-exp) rule, so the result
is EXACT full attention over the whole sequence while no rank ever
materializes more than one remote block.  The attention arithmetic is
plain torch (matmul, exp, max), as the reference's is jax.numpy
outside any kernel.

    python ompi_tpu_torch/examples/ring_attention.py \\
        [--device auto|cpu] [--tokens T] [--dim D]

4 rank-threads, T tokens a rank (8 by default), head width D (16):
``auto`` puts every rank-thread on the card (``run_ranks(...,
devices=True)``: rank i on card i % count), ``cpu`` on the CPU.  The
result is held against plain full attention on the same device at
the reference's tolerance (rtol 2e-4, atol 2e-5).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

RTOL, ATOL = 2e-4, 2e-5


def ring_attention_step(q, k, v, acc, m, l):
    """One block: online-softmax accumulation of attention(q, k, v)
    into (acc, m, l) — numerator, running max, running denominator."""
    s = q @ k.T / np.sqrt(q.shape[-1])                  # (sq, skv)
    m_new = torch.maximum(m, s.max(dim=-1).values)      # (sq,)
    p = torch.exp(s - m_new[:, None])
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(dim=-1)
    acc_new = acc * scale[:, None] + p @ v
    return acc_new, m_new, l_new


def ring_attention(comm, q, k, v):
    """Exact attention over the comm-wide sequence; each rank returns
    its own sequence shard of the output."""
    size = comm.size
    acc = torch.zeros_like(q)
    m = torch.full((q.shape[0],), -torch.inf, dtype=q.dtype,
                   device=q.device)
    l = torch.zeros((q.shape[0],), dtype=q.dtype, device=q.device)
    # ring: block b seen at step t is the one owned by (rank + t)
    perm = [((r + 1) % size, r) for r in range(size)]  # src -> dst
    for _ in range(size):
        acc, m, l = ring_attention_step(q, k, v, acc, m, l)
        k = comm.ppermute_arr(k, perm)
        v = comm.ppermute_arr(v, perm)
    return acc / l[:, None]


def reference_attention(q_full, k_full, v_full):
    """Plain full attention (numpy arrays or torch tensors)."""
    s = q_full @ k_full.T / np.sqrt(q_full.shape[-1])
    if isinstance(s, torch.Tensor):
        return torch.softmax(s, dim=-1) @ v_full
    p = np.exp(s - s.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    return p @ v_full


def inputs(nranks: int, sq: int, d: int):
    """The reference's Q, K, V: float32 standard normals, seed 0."""
    rng = np.random.default_rng(0)
    return tuple(rng.standard_normal((nranks * sq, d)).astype(np.float32)
                 for _ in range(3))


def run(device: str = "auto", nranks: int = 4, sq: int = 8, d: int = 16):
    """Ring attention on ``nranks`` rank-threads, twice; returns (each
    rank's output on its device, the largest error against full
    attention on that device, the slowest rank's ms for its first
    ring_attention call and for its second, warm one)."""
    from ompi_tpu_torch.testing import run_ranks

    Q, K, V = inputs(nranks, sq, d)

    def fn(comm):
        dev = comm.device
        r = comm.rank
        q, k, v = (torch.as_tensor(a[r * sq:(r + 1) * sq], device=dev)
                   for a in (Q, K, V))
        sync = dev.type == "cuda"
        ms = []
        for _ in range(2):  # the first call pays the libraries' set-up
            if sync:
                torch.cuda.synchronize(dev)
            comm.Barrier()
            t0 = time.perf_counter()
            out = ring_attention(comm, q, k, v)
            if sync:
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        # full attention's rows of this shard: its queries against the
        # whole sequence's keys and values
        want = reference_attention(
            q, *(torch.as_tensor(a, device=dev) for a in (K, V)))
        torch.testing.assert_close(out, want, rtol=RTOL, atol=ATOL)
        return out, float((out - want).abs().max()), ms

    if device == "cpu":
        res = run_ranks(nranks, fn, device_map=lambda r: torch.device("cpu"))
    elif device == "auto":
        res = run_ranks(nranks, fn, devices=True)
    else:
        raise ValueError(f"device {device!r}: auto or cpu")
    return ([o for o, _, _ in res], max(e for _, e, _ in res),
            max(t[0] for _, _, t in res), max(t[1] for _, _, t in res))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv

    def opt(name, default):
        return argv[argv.index(name) + 1] if name in argv else default

    device = opt("--device", "auto")
    nranks, sq, d = 4, int(opt("--tokens", 8)), int(opt("--dim", 16))
    outs, err, cold, warm = run(device, nranks, sq, d)
    print(f"ring attention OK: {nranks} ranks x {sq} tokens, "
          f"exact vs full attention (dim {d}, on {outs[0].device}, max "
          f"error {err:.3e}, {warm:.3f} ms; the first call {cold:.3f})")


if __name__ == "__main__":
    main()
