"""Sequence-mixing recurrences, the counterpart of the JAX package's
``models/ssm.py``: Mamba-2 SSD (zamba2) and the xLSTM's mLSTM / sLSTM.

The chunked SSD form (Dao & Gu, 2024, "minimal SSD") is the shared engine:
intra-chunk work is dense products, the state between chunks is carried by
a loop over S/chunk steps.  The mLSTM's chunkwise-parallel form is SSD
with (B=k, C=q, x=i*v, A=log f), so it reuses :func:`ssd_chunked`; its
normalizer runs the same recurrence with P=1.  The sLSTM is sequential by
construction, a loop over the tokens.

Every function takes and returns what the reference's does, in the same
dtypes.  Where ``jnp.einsum`` promotes bf16 x fp32 to fp32 the operands
are cast to fp32 here (``torch`` multiplies no mixed dtypes), and each
multi-operand einsum is written as pairwise products in a fixed order, so
that no intermediate is larger than the fp32 decay matrix ``L``
``[B, nc, H, q, q]`` and the CPU and the card contract alike.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

# 1 / sqrt(hd) rounded in fp32: the reference's scale is a strongly typed
# fp32 scalar, so multiplying a bf16 tensor by it promotes to fp32
from .attention import _scale


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., q] -> [..., q, q] lower-triangular pairwise sums:
    out[..., i, j] = sum(a[..., j+1 : i+1]) for i >= j, -inf above."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]           # sum(j+1..i)
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space dual form.

    x: [B,S,H,P]   (already dt-scaled inputs)
    a: [B,S,H]     log-decay per token (<= 0), fp32
    b: [B,S,N]     input projection  (shared across heads, 1 group)
    c: [B,S,N]     output projection
    returns y: [B,S,H,P] in fp32 (the reference's einsums promote), final
    state [B,H,P,N] in ``x.dtype``
    """
    B, S, H, Pd = x.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(B, nc, chunk, H, Pd).to(f32)
    ac = a.reshape(B, nc, chunk, H).to(f32)
    bc = b.reshape(B, nc, chunk, N).to(f32)
    cc = c.reshape(B, nc, chunk, N)

    acs = torch.cumsum(ac, dim=2)                         # [B,nc,q,H]
    # intra-chunk (diagonal) term: ((C B^T) * L) X, per head
    L = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))        # [B,nc,H,q,q]
    cb = cc.to(f32) @ bc.transpose(-1, -2)                # [B,nc,q,q]
    g = L * cb[:, :, None]
    del L
    y_diag = g @ xc.permute(0, 1, 3, 2, 4)                # [B,nc,H,q,P]
    del g
    # states emitted by each chunk: sum_q (decay * X)^T B
    decay_states = torch.exp(acs[:, :, -1:, :] - acs)     # [B,nc,q,H]
    dx = decay_states[..., None] * xc                     # [B,nc,q,H,P]
    states = dx.permute(0, 1, 3, 4, 2) @ bc[:, :, None]   # [B,nc,H,P,N]
    del dx
    # inter-chunk recurrence
    chunk_decay = torch.exp(acs[:, :, -1, :])             # [B,nc,H]
    h = torch.zeros((B, H, Pd, N), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)                                  # state BEFORE chunk
        h = h * chunk_decay[:, i, :, None, None] + states[:, i]
    h_prev = torch.stack(h_prev, dim=1)                   # [B,nc,H,P,N]
    # off-diagonal (carried-state) term, the state rounded to x.dtype
    hp = h_prev.to(x.dtype).to(f32).reshape(B, nc, H * Pd, N)
    y_off = (cc.to(f32) @ hp.transpose(-1, -2)).reshape(B, nc, chunk, H, Pd)
    y_off = y_off * torch.exp(acs)[..., None]
    y = y_diag.permute(0, 1, 3, 2, 4) + y_off
    return y.reshape(B, S, H, Pd), h.to(x.dtype)


def ssd_decode_step(h: torch.Tensor, x_t: torch.Tensor, a_t: torch.Tensor,
                    b_t: torch.Tensor, c_t: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  h: [B,H,P,N], x_t: [B,H,P], a_t: [B,H] fp32,
    b_t/c_t: [B,N] -> (y_t [B,H,P], h').  The decay is fp32, so h' and
    y_t are fp32 whatever the dtype of ``h``, as in the reference."""
    dec = torch.exp(a_t)[:, :, None, None]
    xb = x_t[..., None] * b_t[:, None, None, :]           # [B,H,P,N]
    h = h.float() * dec + xb.float()
    y = (h @ c_t.float()[:, None, :, None])[..., 0]
    return y, h


# ---------------------------------------------------------------- mLSTM


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_gate: torch.Tensor, f_gate: torch.Tensor, chunk: int,
                  state: Optional[Tuple] = None
                  ) -> Tuple[torch.Tensor, Tuple]:
    """Matrix-LSTM in chunkwise-parallel form (xLSTM).

    q/k: [B,S,H,N]; v: [B,S,H,P]; i_gate/f_gate: [B,S,H]
    (pre-activations).
    C_t = f C_{t-1} + i v k^T ; n_t = f n_{t-1} + i k ;
    y = (C q) / max(|n.q|, 1).
    Maps onto SSD with a = log sigmoid(f), x = i*v, b = k, c = q;
    the normalizer runs the same recurrence with x = i*1.  Each value
    channel is its own row of ``C``, so ``v`` may hold any ``P`` of a
    head's channels (``P = N``: all of them, the reference's call): ``y``
    is then those channels of the whole run's, the scale ``1/√N`` either
    way.  Returns y [B,S,H,P] in fp32 and the final (C [B·H,1,P,N],
    n [B·H,1,1,N]) in ``v.dtype``.
    """
    B, S, H, N = q.shape
    P = v.shape[-1]
    logf = F.logsigmoid(f_gate.float())                   # [B,S,H]
    i_act = torch.exp(torch.clamp(i_gate.float(), max=10.0))

    def fold(t):         # [B,S,H,D] -> [B*H,S,1,D] with H folded in batch
        return t.permute(0, 2, 1, 3).reshape(B * H, S, 1, t.shape[-1])

    xq = fold(v * i_act[..., None].to(v.dtype))
    a = logf.permute(0, 2, 1).reshape(B * H, S, 1)
    bmat = fold(k.float() * _scale(N)).reshape(B * H, S, N)
    cmat = fold(q).reshape(B * H, S, N)
    h0 = None if state is None else state[0]
    y, hT = ssd_chunked(xq, a, bmat, cmat, chunk, h0)
    # normalizer n_t . q_t via the same recurrence with x = i (P=1)
    ones = i_act.permute(0, 2, 1).reshape(B * H, S, 1, 1).to(v.dtype)
    n0 = None if state is None else state[1]
    nrm, nT = ssd_chunked(ones, a, bmat, cmat, chunk, n0)
    denom = torch.clamp(nrm[..., 0].abs(), min=1.0)       # [B*H,S,1]
    y = y[:, :, 0] / denom                                # [B*H,S,P]
    y = y.reshape(B, H, S, P).permute(0, 2, 1, 3)
    return y, (hT, nT)


def mlstm_init_state(batch: int, n_heads: int, hd: int, dtype,
                     device=None, values: Optional[int] = None):
    """The zero state ``(C [B·H,1,P,hd], n [B·H,1,1,hd])`` of ``P =
    values`` value channels a head (default ``hd``: all of them)."""
    p = hd if values is None else values
    return (torch.zeros((batch * n_heads, 1, p, hd), dtype=dtype,
                        device=device),
            torch.zeros((batch * n_heads, 1, 1, hd), dtype=dtype,
                        device=device))


def mlstm_decode_step(state, q_t, k_t, v_t, i_t, f_t):
    """One-token mLSTM.  q/k: [B,H,N], v: [B,H,P] (any ``P`` of a head's
    value channels, as in :func:`mlstm_chunked`), gates [B,H].
    state = (C [B*H,1,P,N], n [B*H,1,1,N]) as from mlstm_init_state.
    The new state is fp32 whatever the dtype of ``state`` (the decay is
    fp32), as in the reference."""
    B, H, N = q_t.shape
    P = v_t.shape[-1]
    C, n = state
    logf = F.logsigmoid(f_t.float()).reshape(B * H, 1)
    i_act = torch.exp(torch.clamp(i_t.float(), max=10.0)).reshape(B * H)
    kf = (k_t.float() * _scale(N)).reshape(B * H, N).to(C.dtype)
    qf = q_t.reshape(B * H, N).to(C.dtype)
    vf = (v_t.reshape(B * H, P).float() * i_act[:, None]).to(C.dtype)
    # SSD layout: h [B',1,P,N] with the fused B*H batch and one "head"
    y, C2 = ssd_decode_step(C, vf[:, None, :], logf, kf, qf)  # [B',1,P]
    ones = i_act[:, None, None].to(C.dtype)                   # x=i, P=1
    nrm, n2 = ssd_decode_step(n, ones, logf, kf, qf)          # [B',1,1]
    denom = torch.clamp(nrm.abs(), min=1.0)
    y = (y / denom).reshape(B, H, P)
    return y, (C2, n2)


# ---------------------------------------------------------------- sLSTM


def slstm_scan(x_parts: torch.Tensor, r_weights: torch.Tensor,
               state: Optional[Tuple] = None,
               exchange: Optional[Callable[[torch.Tensor], torch.Tensor]]
               = None) -> Tuple[torch.Tensor, Tuple]:
    """Scalar-LSTM with exponential gating + per-head state mixing.

    x_parts: [B,S,4,H,hd] — precomputed W{z,i,f,o} @ x per token.
    r_weights: [4,H,hd,hd] — recurrent block-diagonal matrices.
    Sequential loop over S (state mixing is inherently serial); the four
    recurrent products of a step are one batched product on ``r`` stacked
    to [H, hd, 4·hd].  Returns h_seq [B,S,H,hd] (fp32) and the final
    state (c, n, h, m), fp32.

    ``exchange``: a caller that computes only ``P`` of each head's output
    channels passes ``x_parts`` [B,S,4,H,P] and ``r_weights``
    [4,H,hd,P] of those channels; ``c``, ``n`` and ``m`` are then
    [B,H,P], and each step's ``h`` [B,H,P] becomes, through
    ``exchange``, the whole ``h`` [B,H,hd] that the next step's product
    and ``h_seq`` take.  ``None``: every channel, the reference's loop.
    """
    B, S, _, H, P = x_parts.shape
    hd = r_weights.shape[2]
    f32 = torch.float32
    if state is None:
        z0 = torch.zeros((B, H, P), dtype=f32, device=x_parts.device)
        h0 = z0 if exchange is None else torch.zeros(
            (B, H, hd), dtype=f32, device=x_parts.device)
        state = (z0, z0 + 1e-6, h0, z0 - 10.0)            # c, n, h, m
    c, n, h, m = state
    r = r_weights.to(f32).permute(1, 2, 0, 3).reshape(H, hd, 4 * P)
    xs = x_parts.to(f32)
    hs = []
    for t in range(S):
        rr = torch.bmm(h.transpose(0, 1), r)              # [H,B,4*P]
        g = xs[:, t] + rr.reshape(H, B, 4, P).permute(1, 2, 0, 3)
        zt = torch.tanh(g[:, 0])
        it = g[:, 1]
        fm = g[:, 2] + m
        ot = torch.sigmoid(g[:, 3])
        m = torch.maximum(fm, it)                         # stabilizer
        ip = torch.exp(it - m)
        fp = torch.exp(fm - m)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp(n, min=1.0)
        if exchange is not None:
            h = exchange(h)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, h, m)
