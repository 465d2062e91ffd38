"""Ring attention: sequence parallelism (port of
``znicz_tpu/parallel/ring_attention.py``).

Time is split over the ring's members.  Each member keeps its Q shard
and passes its K/V shard to the next member, folding every arriving
block into its (out, lse) pair, so no member ever holds the whole
(T, T) score matrix.  Each hop is one flash-kernel pass
(:func:`~znicz_tpu_torch.ops.flash_attention.flash_attention_fwd`, B7)
at the hop's global ``(q_offset, k_offset)``, and hops combine as the
reference's ``_ring_kernel_fold`` combines them::

    m = max(lse₁, lse₂),  wᵢ = exp(lseᵢ − m)
    out = (out₁·w₁ + out₂·w₂) / (w₁ + w₂),  lse = m + log(w₁ + w₂)

The local block is folded first (it holds the causal diagonal, so lse
starts finite); a causal hop wholly above the diagonal gives lse −1e30
and weight 0.  The backward (:class:`RingFold`, one
``torch.autograd.Function``) takes the final ``(out, lse)`` and
``delta = rowsum(do·out)``, runs the dq kernel (B8) and the dk/dv kernel
(B9) for every hop at the hop's offsets, and sends each dk/dv
accumulator around the ring with its K/V block, back to its owner.

The transport is the only thing that differs between real and emulated
members:

- :class:`ProcessRing` is one member a process, over a process group (the
  mesh's ``seq`` axis, else ``model``): ``batch_isend_irecv`` to the
  next member and from the previous one;
- :class:`LocalRing` holds all N members in one process (the
  reference's virtual CPU mesh, ``make_seq_mesh``): a rotation is a
  reindex.  Tests and ``chip_smoke.py`` use it; no entry point does.

The hop loop, the combine and the autograd ``Function`` are one code
path over a list of the members this process holds (one, or all N).

:func:`ring_fold_choice` is the reference's gate: a head dim the kernels
cannot take (:func:`~znicz_tpu_torch.ops.flash_attention.kernel_legal`)
runs the same fold through the kernels' plain versions, on every
device, as the attention unit routes such a head dim to its plain core.
:func:`local_attention` (the whole-sequence oracle) and
:func:`local_attention_blocked` (the online-softmax fold over K blocks
in one process) are the reference's single-device forms.
"""

from __future__ import annotations

import math

import torch

from znicz_tpu_torch.ops import flash_attention as fa
from znicz_tpu_torch.ops.flash_attention import local_attention
from znicz_tpu_torch.parallel.axis import MODEL_AXIS, SEQ_AXIS

__all__ = ["LocalRing", "ProcessRing", "RingFold", "local_attention",
           "local_attention_blocked", "ring_axis", "ring_fold_choice",
           "sequence_sharded_attention"]

_NEG_INF = fa.NEG_INF


# ----------------------------------------------------------------------
# transports
# ----------------------------------------------------------------------
class LocalRing:
    """All ``n`` members of the ring in this process: member ``i`` holds
    shard ``i`` of every list, and a rotation hands member ``i`` the
    block member ``i − 1`` held."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"a ring of {n} members")
        self.n = int(n)

    @property
    def members(self) -> list[int]:
        return list(range(self.n))

    def rotate(self, blocks: list) -> list:
        """``blocks[i]`` (a tuple of tensors) moves to member ``i + 1``."""
        return [blocks[(i - 1) % self.n] for i in range(self.n)]


class ProcessRing:
    """One member a process, over ``group``: a rotation sends this
    member's block to the next member and receives the previous one's
    (``batch_isend_irecv``, NCCL or gloo)."""

    def __init__(self, group) -> None:
        import torch.distributed as dist
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._next = dist.get_global_rank(group, (self.rank + 1) % self.n)
        self._prev = dist.get_global_rank(group, (self.rank - 1) % self.n)

    @property
    def members(self) -> list[int]:
        return [self.rank]

    def rotate(self, blocks: list) -> list:
        import torch.distributed as dist
        (block,) = blocks
        out = tuple(torch.empty_like(t) for t in block)
        ops = []
        for send, recv in zip(block, out):
            send = send.contiguous()
            ops.append(dist.P2POp(dist.isend, send, self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, recv, self._prev, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [out]


def ring_axis(mesh) -> str | None:
    """The axis the ring rides on ``mesh``: ``seq`` when it has 2 or more
    members, else ``model`` when that does, else None (the reference's
    rule)."""
    if mesh is None:
        return None
    for axis in (SEQ_AXIS, MODEL_AXIS):
        if mesh.size(axis) > 1:
            return axis
    return None


def ring_fold_choice(shape, n_members: int) -> str:
    """``"kernel"`` when the flash kernels take the per-member shards of
    a global (B, T, H, dh) shape, else ``"plain"`` (the same fold through
    the kernels' plain versions).  Time must split evenly."""
    _, t, _, dh = shape
    if t % n_members:
        raise ValueError(f"sequence of {t} does not split over a ring of "
                         f"{n_members}")
    return "kernel" if fa.kernel_legal(dh) else "plain"


# ----------------------------------------------------------------------
# the fold
# ----------------------------------------------------------------------
_FNS = {"kernel": (fa.flash_attention_fwd, fa.flash_attention_dq,
                   fa.flash_attention_dkv),
        "plain": (fa.flash_attention_plain, fa.flash_attention_dq_plain,
                  fa.flash_attention_dkv_plain)}


def _combine(o, lse, o_h, lse_h):
    """Fold a hop's ``(o_h, lse_h)`` into the running f32 ``(o, lse)``;
    o (B, T, H, dh), lse (B, H, T)."""
    m = torch.maximum(lse, lse_h)
    w1, w2 = torch.exp(lse - m), torch.exp(lse_h - m)
    total = w1 + w2
    a = (w1 / total).transpose(1, 2).unsqueeze(-1)
    b = (w2 / total).transpose(1, 2).unsqueeze(-1)
    return o * a + o_h.float() * b, m + torch.log(total)


def _forward(ring, fold, causal, qs, ks, vs):
    """``(outs, lses)`` of every member this process holds: outs in q's
    dtype, lses f32."""
    fwd = _FNS[fold][0]
    t = qs[0].shape[1]
    members = ring.members
    state = []
    for r, q, k, v in zip(members, qs, ks, vs):
        o, lse = fwd(q, k, v, causal, r * t, r * t)  # the diagonal first
        state.append([o.float(), lse])
    blocks = list(zip(ks, vs))
    for i in range(1, ring.n):
        blocks = ring.rotate(blocks)
        for j, (r, q) in enumerate(zip(members, qs)):
            src = (r - i) % ring.n          # the arriving block's owner
            k, v = blocks[j]
            o_h, lse_h = fwd(q, k, v, causal, r * t, src * t)
            state[j] = list(_combine(*state[j], o_h, lse_h))
    return ([o.to(q.dtype) for (o, _), q in zip(state, qs)],
            [lse for _, lse in state])


def _backward(ring, fold, causal, qs, ks, vs, outs, lses, douts, dlses):
    """``(dqs, dks, dvs)`` from the final ``(out, lse)`` of each member
    and their cotangents: ``delta = rowsum(do·out) − dlse``, then every
    hop's dq and dk/dv at its offsets, the dk/dv sums travelling with
    their K/V block and handed back to the owner."""
    _, dq_fn, dkv_fn = _FNS[fold]
    t = qs[0].shape[1]
    members = ring.members
    dos = [do.to(q.dtype) for do, q in zip(douts, qs)]
    deltas = [((do.float() * o.float()).sum(-1).transpose(1, 2)
               - dlse.float()).contiguous()
              for do, o, dlse in zip(dos, outs, dlses)]
    dqs = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    blocks = [(k, v, torch.zeros_like(k, dtype=torch.float32),
               torch.zeros_like(v, dtype=torch.float32))
              for k, v in zip(ks, vs)]
    for i in range(ring.n):
        if i:
            blocks = ring.rotate(blocks)
        for j, r in enumerate(members):
            src = (r - i) % ring.n
            k, v, dk, dv = blocks[j]
            args = (qs[j], k, v, dos[j], lses[j], deltas[j], causal, r * t,
                    src * t)
            dqs[j] += dq_fn(*args).float()
            dk_h, dv_h = dkv_fn(*args)
            dk += dk_h.float()
            dv += dv_h.float()
    # each member holds the sums of the block of member r + 1: one more
    # step hands every sum to its owner
    blocks = ring.rotate([(dk, dv) for _, _, dk, dv in blocks])
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for (dk, _), k in zip(blocks, ks)],
            [dv.to(v.dtype) for (_, dv), v in zip(blocks, vs)])


class RingFold(torch.autograd.Function):
    """The ring as one differentiable call over the members this process
    holds: ``apply(ring, fold, causal, *qs, *ks, *vs)`` →
    ``(*outs, *lses)`` (outs in q's dtype, lses f32).  The lse cotangent
    enters ``delta``, as in the reference's ``_hop_bwd``."""

    @staticmethod
    def forward(ctx, ring, fold, causal, *tensors):
        m = len(tensors) // 3
        qs, ks, vs = tensors[:m], tensors[m:2 * m], tensors[2 * m:]
        outs, lses = _forward(ring, fold, causal, qs, ks, vs)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.geometry = (ring, fold, causal, m)
        ctx.set_materialize_grads(True)
        return (*outs, *lses)

    @staticmethod
    def backward(ctx, *grads):
        ring, fold, causal, m = ctx.geometry
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:m], saved[m:2 * m], saved[2 * m:3 * m]
        outs, lses = saved[3 * m:4 * m], saved[4 * m:]
        dqs, dks, dvs = _backward(ring, fold, causal, qs, ks, vs, outs,
                                  lses, grads[:m], grads[m:])
        return (None, None, None, *dqs, *dks, *dvs)


def ring_fold(ring, qs, ks, vs, causal: bool = False,
              fold: str = "kernel") -> list:
    """The ring over the members' shards (lists of (B, t, H, dh)):
    each member's output, in q's dtype, differentiable."""
    out = RingFold.apply(ring, fold, bool(causal), *qs, *ks, *vs)
    return list(out[:len(qs)])


def sequence_sharded_attention(ring, q, k, v, causal: bool = False,
                               dot_dtype: torch.dtype | None = None
                               ) -> torch.Tensor:
    """Attention with time split over ``ring``, f32 out (the reference's
    entry).  With a :class:`LocalRing`, q/k/v are the whole (B, T, H, dh)
    tensors and the output is too; with a :class:`ProcessRing` they are
    this process's time shard and so is the output.  ``dot_dtype`` casts
    the operands first, as :func:`flash_attention` does."""
    if dot_dtype is not None:
        q, k, v = (a.to(dot_dtype) for a in (q, k, v))
    members = len(ring.members)
    fold = ring_fold_choice((q.shape[0], q.shape[1] * ring.n // members,
                             q.shape[2], q.shape[3]), ring.n)
    if members == 1:
        return ring_fold(ring, [q], [k], [v], causal, fold)[0].float()
    split = [a.chunk(members, dim=1) for a in (q, k, v)]
    outs = ring_fold(ring, *split, causal=causal, fold=fold)
    return torch.cat(outs, dim=1).float()


def _fold_block(carry, q, k_blk, v_blk, mask, dot_dtype=None):
    """Online-softmax fold of one K/V block into (m, denom, acc), f32
    statistics (the reference's ``_fold_block``)."""
    m, denom, acc = carry
    d = q.shape[-1]
    if dot_dtype is not None:
        q, k_blk = q.to(dot_dtype), k_blk.to(dot_dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) \
        / math.sqrt(d)
    s = s.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None]).masked_fill(~mask, 0.0)
    correction = torch.exp(m - m_new)
    if dot_dtype is not None:
        p, v_blk = p.to(dot_dtype), v_blk.to(dot_dtype)
    acc = acc * correction[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.float(), v_blk.float())
    denom = denom * correction + p.float().sum(dim=-1)
    return m_new, denom, acc


def local_attention_blocked(q, k, v, causal: bool = False,
                            block_k: int = 512,
                            dot_dtype: torch.dtype | None = None
                            ) -> torch.Tensor:
    """Single-device attention as an online-softmax fold over K/V blocks
    of ``block_k`` (the reference's ``local_attention_blocked``): the
    same math as :func:`local_attention`, f32 out, differentiable by
    autograd."""
    b, t, h, d = q.shape
    tk = k.shape[1]
    if tk % block_k:
        raise ValueError(f"T_k {tk} not divisible by block_k {block_k}")
    dev = q.device
    m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=dev)
    denom = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=dev)
    q_pos = torch.arange(t, device=dev)
    for i in range(tk // block_k):
        sl = slice(i * block_k, (i + 1) * block_k)
        if causal:
            k_pos = i * block_k + torch.arange(block_k, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        else:
            mask = torch.ones((1, 1, t, block_k), dtype=torch.bool,
                              device=dev)
        m, denom, acc = _fold_block((m, denom, acc), q, k[:, sl],
                                    v[:, sl], mask, dot_dtype)
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.transpose(1, 2)


class _GatherTime(torch.autograd.Function):
    """Every ring member's (B, t, ...) block concatenated along time on
    every member; the backward keeps this member's block of the
    cotangent (the computation after it is the same on every member)."""

    @staticmethod
    def forward(ctx, x, ring):
        from znicz_tpu_torch.parallel.axis import all_gather_flat
        ctx.ring = ring
        moved = x.movedim(1, 0).contiguous()
        whole = moved.new_empty((ring.n * moved.shape[0],)
                                + tuple(moved.shape[1:]))
        all_gather_flat(whole, moved, ring.group)
        return whole.movedim(0, 1).contiguous()

    @staticmethod
    def backward(ctx, grad):
        ring = ctx.ring
        t = grad.shape[1] // ring.n
        return grad[:, ring.rank * t:(ring.rank + 1) * t], None


def gather_time(x: torch.Tensor, ring: ProcessRing) -> torch.Tensor:
    """The ring members' time blocks of ``x`` concatenated, on every
    member (an all-gather), differentiable."""
    return _GatherTime.apply(x, ring)
