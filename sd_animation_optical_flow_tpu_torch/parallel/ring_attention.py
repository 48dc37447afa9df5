"""Sequence-parallel self-attention: ring attention and Ulysses.

Counterpart of ``sd_animation_optical_flow_tpu/parallel/ring_attention.py``
in SPMD form: every rank calls these functions with its own contiguous
slice of the token axis, q/k/v [B, n_local, H, D] (rank r holding tokens
[r * n_local, (r + 1) * n_local)), and gets its slice of the output. The
JAX functions take the whole sharded arrays under ``shard_map``; the
rank's body is the same.

* :func:`ring_attention` keeps q and passes K/V around the ring of the
  mesh axis (``batch_isend_irecv``, the next block in flight while the
  current one is used), with an f32 online softmax. Plain torch ops, as
  the JAX body is einsums.
* :func:`ulysses_attention` turns the sequence sharding into a head
  sharding with one all-to-all ([B, n_local, H, D] -> [B, N, H / n, D]),
  attends over the whole sequence on the rank's heads, and turns it back
  with a second all-to-all. The inner attention is ``attn_fn`` (the MFR
  strip attention of ``ops/attention.py``: kernel #10 past its gate) or
  the port's ``attention`` router (kernel #1 past its gate).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..ops.attention import attention
from .mesh import axis_group


def ring_attention(q, k, v, mesh, *, seq_axis: str = "dp"):
    """Softmax attention of this rank's queries over the keys of every rank
    on ``mesh``'s ``seq_axis``. q/k/v [B, n_local, H, D]; returns [B,
    n_local, H, D] in q's dtype. After n steps each rank has seen every K/V
    block; the blocks travel to the next rank while the current one is
    used (the last step sends nothing)."""
    group, rank, n = axis_group(mesh, seq_axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    m = torch.full(q.shape[:3], -math.inf, device=q.device)      # [B, n, H]
    l = torch.zeros(q.shape[:3], device=q.device)
    acc = torch.zeros(qf.shape, device=q.device)
    kv = torch.stack([k, v]).contiguous()            # one message a step
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prev = dist.get_global_rank(group, (rank - 1) % n)
    for step in range(n):
        reqs = []
        if step < n - 1:
            incoming = torch.empty_like(kv)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, kv, nxt, group),
                dist.P2POp(dist.irecv, incoming, prev, group)])
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kv[0].float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p, kv[1].float())
        m = m_new
        for req in reqs:
            req.wait()
        if reqs:
            kv = incoming
    return (acc / l[..., None]).to(q.dtype)


def _seq_to_heads(ts, group, n: int):
    """The tiled all-to-all [B, n_local, H, D] -> [B, N, H / n, D] of every
    tensor of ``ts`` in one collective: returns them as views of one
    [B, N, len(ts), H / n, D] buffer (rows of H / n * D contiguous
    elements, which the attention kernels take as they are)."""
    b, nl, h, d = ts[0].shape
    send = torch.empty((n, b, nl, len(ts), h // n, d), dtype=ts[0].dtype,
                       device=ts[0].device)
    for i, t in enumerate(ts):
        send[:, :, :, i] = t.reshape(b, nl, n, h // n, d).permute(2, 0, 1, 3,
                                                                  4)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] holds rank j's tokens of this rank's heads: tokens in order
    full = recv.transpose(0, 1).reshape(b, n * nl, len(ts), h // n, d)
    return [full[:, :, i] for i in range(len(ts))]


def _heads_to_seq(o, group, n: int):
    """Inverse of :func:`_seq_to_heads` for one tensor: [B, N, H / n, D]
    -> [B, n_local, H, D]."""
    b, nt, hl, d = o.shape
    send = o.reshape(b, n, nt // n, hl, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j] holds head group j of this rank's tokens
    return recv.permute(1, 2, 0, 3, 4).reshape(b, nt // n, n * hl, d)


def ulysses_attention(q, k, v, mesh, *, seq_axis: str = "dp", attn_fn=None):
    """Ulysses sequence-parallel self-attention: one all-to-all to a head
    sharding, full-sequence attention over this rank's H / n heads, and one
    all-to-all back. q/k/v [B, n_local, H, D] (this rank's tokens);
    returns [B, n_local, H, D] in q's dtype.

    ``attn_fn(qh, kh, vh) -> [B, N, H / n, D]`` replaces the default inner
    attention (the ``attention`` router): position-dependent biases such
    as the MFR strip band need no re-indexing, since every rank sees the
    whole sequence of its heads. Requires H % n == 0 (ValueError)."""
    group, _, n = axis_group(mesh, seq_axis)
    if q.shape[2] % n:
        raise ValueError(f"{q.shape[2]} heads do not divide over the {n} "
                         f"ranks of mesh axis '{seq_axis}'")
    qh, kh, vh = _seq_to_heads((q, k, v), group, n)
    o = (attn_fn or attention)(qh, kh, vh).to(q.dtype)
    return _heads_to_seq(o, group, n)
