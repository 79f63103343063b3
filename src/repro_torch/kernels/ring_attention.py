"""Ring attention: flash attention over a sequence split across the ranks of
a ``torch.distributed`` group.

Each rank holds a local q shard and a local K/V panel of the sequence.  The
panels travel around the group's ring, rank ``i`` to rank ``i + 1``, while
the queries stay put.  Every round runs one *panel visit*: the partial flash
kernel over (local q, visiting K/V panel) gives the un-normalised
online-softmax state (acc, m, l), and the rounds merge their states with the
log-sum-exp combine.  After P rounds (P = group size) every rank has
attended its q shard to the whole sequence; the result equals flash
attention on the gathered sequence.

The kernel replaces the TPU kernel
``repro/kernels/ring_attention.py::_flash_partial`` (``_partial_kernel``).
It is a compile-time variant of the flash kernel's bodies in
``csrc/flash_attention.cu`` (bf16 on ``wgmma`` tensor cores with K/V by
TMA, fp32 on exact FMA loops), where the source says what bounds it on the
H100.  Masks are expressed through ``delta = q_start - k_start``, the offset
of the local q shard against the visiting panel's global origin:
``k_global <= q_global`` is exactly ``k_local <= q_local + delta``.  The
merge and the final division run in plain PyTorch on every device, as the
JAX package runs them outside its kernel (``kernels/ref.py``).

:func:`flash_partial_cuda` only launches the kernel; ``kernels/ops.py``
picks it for CUDA tensors and ``kernels/ref.py::flash_partial_ref`` for CPU
tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .flash_attention import _DTYPES, _lib, _validate_attn_shapes, check_inputs
from .ref import State, finalize_partial, merge_partials


def check_panel(H: int, KV: int, window: Optional[int]) -> None:
    """A panel visit's own checks: the GQA grouping and a positive window.
    A window longer than the panel is fine; :func:`ring_flash_attention`
    checks it against the whole sequence."""
    _validate_attn_shapes(1, 1, H, KV, None)
    if window is not None and window <= 0:
        raise ValueError(f"sliding window must be a positive span, got "
                         f"window={window} (every position would be masked)")


def check_no_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  fn: str) -> None:
    """Raise ValueError when autograd would record a panel visit: it has no
    backward yet (K5 in ``ROADMAP.md``).  On the card the visit's outputs
    would carry no ``grad_fn``, so q, k and v would get no gradient without
    an error; on the CPU the plain visit's in-place steps break
    ``.backward()``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise ValueError(
            f"{fn} has no backward yet (K5, the ring's panel-visit "
            "backward): call it under torch.no_grad(), or train through "
            "flash attention on the gathered sequence")


def flash_partial_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       delta: int, *, causal: bool = True,
                       window: Optional[int] = None) -> State:
    """Launch the panel-visit kernel: q (B,S,H,dh); k/v (B,T,KV,dh) ->
    (acc (B,S,H,dh), m (B,S,H,1), l (B,S,H,1)), fp32, with the semantics of
    :func:`~repro_torch.kernels.ref.flash_partial_ref`.

    Tensors must lie on one CUDA device, share a dtype (float32 or
    bfloat16) and have dh in {64, 128}.  Raises otherwise, and raises if the
    launch fails; it never computes on another path."""
    check_panel(q.shape[2], k.shape[2], window)
    q, k, v = check_inputs(q, k, v, "flash_partial_cuda")
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty(B, S, H, dh, **f32)
    m = torch.empty(B, S, H, 1, **f32)
    l = torch.empty(B, S, H, 1, **f32)
    if acc.numel() == 0:
        return acc, m, l
    # the kernel reads its offset per lane on the device
    offs = torch.full((B,), int(delta), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_partial_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), offs.data_ptr(), B, S, T, H, KV, dh,
            _DTYPES[q.dtype], int(causal),
            0 if window is None else int(window), 1.0 / dh ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_partial kernel launch failed: CUDA "
                           f"error {err}")
    flash_partial_cuda.launches += 1
    return acc, m, l


flash_partial_cuda.launches = 0


def host_tensor(x: torch.Tensor) -> torch.Tensor:
    """x in host memory for gloo: a CUDA tensor is copied into a pinned
    buffer (waiting for the copy), a CPU tensor is host memory already.
    The ring's panels and the pipeline's hand-offs travel so."""
    if not x.is_cuda:
        return x.contiguous()
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, group: Optional[dist.ProcessGroup] = None,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Sequence-parallel flash attention; call on every rank of ``group``.

    q (B, S/P, H, dh); k/v (B, T/P, KV, dh): this rank's shards of a
    sequence split in rank order over the P ranks of ``group``.  Returns
    the local (B, S/P, H, dh) output shard, equal to flash attention on the
    gathered sequence.  ``group=None`` is a ring of one rank (no process
    group): plain flash attention, as the JAX package's ``axis_size=1``,
    which trains.  A ring of more ranks has no backward yet: inputs that
    need gradients raise ValueError while grad is enabled
    (:func:`check_no_grad`).

    Each round's hand-off of the current panel to the next rank is issued
    *before* the round's kernel, so the transfer has no dependency on it
    and runs under it (the JAX package's ``ppermute`` idiom).  A causally
    dead visit (a panel wholly in this shard's future) still launches and
    gives an empty state, which the merge ignores.

    Transport, chosen by ``dist.get_backend(group)`` and by nothing else:
    ``nccl`` sends the CUDA panels as they are; ``gloo`` carries only host
    memory, so the panels travel as host tensors (a CUDA panel is staged
    once into pinned host buffers, and each received panel is copied to
    the device for the kernel).  Any other backend raises."""
    from . import ops

    P = 1 if group is None else dist.get_world_size(group)
    B, S_loc, H, dh = q.shape
    T_loc, KV = k.shape[1], k.shape[2]
    _validate_attn_shapes(S_loc * P, T_loc * P, H, KV, window)
    if P == 1:
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    check_no_grad(q, k, v, "ring_flash_attention")
    backend = dist.get_backend(group)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"ring attention carries panels over nccl or gloo; "
                         f"the group's backend is {backend!r}")
    rank = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % P)
    prv = dist.get_global_rank(group, (rank - 1) % P)
    q_start = rank * S_loc

    # the panel as it travels: device tensors on nccl, host tensors on gloo
    travel = [x.contiguous() if backend == "nccl" else host_tensor(x)
              for x in (k, v)]
    k_cur, v_cur = k, v
    state: Optional[State] = None
    for r in range(P):
        if r < P - 1:
            recv = [torch.empty_like(x) if backend == "nccl" else
                    torch.empty(x.shape, dtype=x.dtype, pin_memory=q.is_cuda)
                    for x in travel]
            reqs = dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, nxt, group) for x in travel]
                + [dist.P2POp(dist.irecv, x, prv, group) for x in recv])
        src = (rank - r) % P            # original owner of k_cur / v_cur
        delta = q_start - src * T_loc
        part = ops.flash_partial(q, k_cur, v_cur, delta, causal=causal,
                                 window=window)
        # merging into the empty state is the identity: start from part
        state = part if state is None else merge_partials(state, part)
        if r < P - 1:
            for req in reqs:
                req.wait()
            travel = recv
            k_cur, v_cur = (x.to(q.device, non_blocking=True)
                            for x in travel)
    return finalize_partial(state, q.dtype)

