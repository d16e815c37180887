"""Mamba-2 (SSD, state-space duality) mixer: chunked dual form and one-step decode.

PyTorch counterpart of ``repro.models.mamba2``.  Full and prefill use the
chunked SSD algorithm (arXiv:2405.21060 §6): within a chunk an
attention-like (Q x Q) masked product, across chunks a scan that carries the
(H, N, P) state and emits the state before each chunk.  Decode is the plain
recurrence on one token.  ``A_log`` and ``dt_bias`` are float32 whatever the
model's dtype, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import Drawn, empty_param, normal, ones, rms_norm, zeros


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return s, d_in, n_heads, conv_ch


class Mamba2(Drawn):
    """Separate projections as the reference's: ``in_zx`` (d, 2 d_in),
    ``in_bc`` (d, 2 g n), ``in_dt`` (d, H); the depthwise conv in two segments
    (``conv_wx``/``conv_bx`` over x, ``conv_wbc``/``conv_bbc`` over B and C);
    ``A_log``, ``dt_bias`` (float32), ``D_skip``, ``gate_norm`` and ``out``."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        s, d_in, n_heads, _ = _dims(cfg)
        d, bc = cfg.d_model, 2 * s.n_groups * s.d_state
        self.in_zx = empty_param((d, 2 * d_in), dtype, device, axes=("embed", "inner"))
        self.in_bc = empty_param((d, bc), dtype, device, axes=("embed", None))
        self.in_dt = empty_param((d, n_heads), dtype, device, axes=("embed", None))
        self.conv_wx = empty_param((s.d_conv, d_in), dtype, device, axes=(None, "inner"))
        self.conv_bx = empty_param((d_in,), dtype, device, axes=("inner",))
        self.conv_wbc = empty_param((s.d_conv, bc), dtype, device, axes=(None, None))
        self.conv_bbc = empty_param((bc,), dtype, device, axes=(None,))
        self.A_log = empty_param((n_heads,), torch.float32, device, axes=(None,))
        self.dt_bias = empty_param((n_heads,), torch.float32, device, axes=(None,))
        self.D_skip = empty_param((n_heads,), dtype, device, axes=(None,))
        self.gate_norm = empty_param((d_in,), dtype, device, axes=("inner",))
        self.out = empty_param((d_in, d), dtype, device, axes=("inner", "embed"))

    def init_plan(self) -> list:
        return [(self.in_zx, normal()), (self.in_bc, normal()), (self.in_dt, normal()),
                (self.conv_wx, normal(0.5)), (self.conv_bx, zeros),
                (self.conv_wbc, normal(0.5)), (self.conv_bbc, zeros), (self.A_log, _a_log),
                (self.dt_bias, _dt_bias), (self.D_skip, ones), (self.gate_norm, ones),
                (self.out, normal())]

    def forward(self, x, *, mode: str = "full", cache=None):
        """Returns (y, new_cache).  cache = {"conv_x": (B,K-1,d_in),
        "conv_bc": (B,K-1,2gn), "ssm": (B,H,N,P)}."""
        cfg = self.cfg
        s_cfg, d_in, n_heads, _ = _dims(cfg)
        bsz, s, _ = x.shape
        hp = s_cfg.head_dim
        g, n = s_cfg.n_groups, s_cfg.d_state
        per_group = n_heads // g

        zx = x @ self.in_zx
        z, xin = zx[..., :d_in], zx[..., d_in:]
        bc = x @ self.in_bc
        dt = F.softplus((x @ self.in_dt).float() + self.dt_bias.float())   # (B,S,H)
        a_h = -torch.exp(self.A_log.float())                               # (H,) < 0

        state_x = cache["conv_x"] if cache is not None else None
        state_bc = cache["conv_bc"] if cache is not None else None
        xin_c, tail_x = _causal_conv(xin, self.conv_wx, self.conv_bx, state_x)
        y_bc, tail_bc = _causal_conv(bc, self.conv_wbc, self.conv_bbc, state_bc)
        b_h = _per_head(y_bc[..., :g * n].reshape(bsz, s, g, n), per_group)
        c_h = _per_head(y_bc[..., g * n:].reshape(bsz, s, g, n), per_group)

        if mode == "decode":
            xh = xin_c.reshape(bsz, s, n_heads, hp).float()
            b_h, c_h = b_h.float(), c_h.float()
            # one-step recurrence (s == 1)
            da = torch.exp(dt[:, 0] * a_h[None, :])                        # (B,H)
            state = cache["ssm"].float()
            state = (state * da[:, :, None, None]
                     + torch.einsum("bh,bhc,bhp->bhcp", dt[:, 0], b_h[:, 0], xh[:, 0]))
            y = torch.einsum("bhc,bhcp->bhp", c_h[:, 0], state)[:, None]  # (B,1,H,P)
            new_cache = {"conv_x": tail_x, "conv_bc": tail_bc,
                         "ssm": state.to(cache["ssm"].dtype)}
            skip = xh
        else:
            xh = xin_c.reshape(bsz, s, n_heads, hp)
            chunk = min(s_cfg.chunk, s)
            if s % chunk:
                raise ValueError(f"sequence length {s} is not a multiple of the SSD chunk "
                                 f"{chunk}")
            y, final_state = _ssd_chunked(xh, b_h, c_h, dt, a_h, chunk)
            new_cache = None
            if mode == "prefill":
                new_cache = {"conv_x": tail_x.to(x.dtype), "conv_bc": tail_bc.to(x.dtype),
                             "ssm": final_state.to(x.dtype)}
            skip = xin_c

        y = y.float() + self.D_skip.float()[None, None, :, None] \
            * skip.reshape(bsz, s, n_heads, hp).float()
        y = y.reshape(bsz, s, d_in).to(x.dtype)
        y = rms_norm(y * F.silu(z), self.gate_norm, cfg.norm_eps)
        return y @ self.out, new_cache


def _a_log(t, gen):
    t.copy_(torch.log(torch.arange(1, t.shape[0] + 1, dtype=torch.float32, device=t.device)))


def _dt_bias(t, gen):
    """dt bias so that softplus(dt_bias) spans ~[1e-3, 1e-1]."""
    dt0 = torch.empty(t.shape[0], dtype=torch.float32, device=t.device)
    dt0 = torch.exp(dt0.uniform_(math.log(1e-3), math.log(1e-1), generator=gen))
    t.copy_(dt0 + torch.log(-torch.expm1(-dt0)))   # inverse softplus


def _per_head(t, per_group: int):
    """(B, S, G, N) -> (B, S, G * per_group, N), each group repeated for its
    heads (``jnp.repeat`` on axis 2)."""
    b, s, g, n = t.shape
    return t[:, :, :, None, :].expand(b, s, g, per_group, n).reshape(b, s, g * per_group, n)


def _causal_conv(u, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv.  u: (B,S,C); conv_w: (K,C).  Returns (y, tail).

    ``conv_state``: (B, K-1, C), the context carried from earlier tokens."""
    k = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype, device=u.device)
    else:
        pad = conv_state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)                   # (B, S+K-1, C)
    # y[t] = sum_j w[j] * ext[t+j], summed in the reference's order
    y = sum(ext[:, j:j + u.shape[1], :] * conv_w[j][None, None, :] for j in range(k))
    tail = ext[:, -(k - 1):, :] if k > 1 else torch.zeros_like(pad)
    return F.silu(y + conv_b[None, None, :]), tail


def _ssd_chunked(xh, b_mat, c_mat, dt, a_h, chunk: int, state0=None):
    """Chunked SSD.  xh: (B,S,H,P); b/c: (B,S,H,N) (group-expanded);
    dt: (B,S,H) (>= 0); a_h: (H,) negative.  Returns (y, final_state)."""
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    nc = s // chunk

    xc = xh.reshape(bsz, nc, chunk, h, p).float()
    bc = b_mat.reshape(bsz, nc, chunk, h, n).float()
    cc = c_mat.reshape(bsz, nc, chunk, h, n).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    da = dtc * a_h.float()[None, None, None, :]          # (B,nc,Q,H) <= 0
    cum = torch.cumsum(da, dim=2)                        # within-chunk cumsum

    # intra-chunk: scores[i,j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i;
    # exp overflows above the diagonal and the where drops it (no inf * 0)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,K,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    decay = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    cb = torch.einsum("bnqhc,bnkhc->bnqkh", cc, bc)      # (B,nc,Q,K,H)
    w_att = cb * decay * dtc[:, :, None, :, :]           # weight on x_k
    y_intra = torch.einsum("bnqkh,bnkhp->bnqhp", w_att, xc)

    # chunk summary states: S_n = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)       # (B,nc,Q,H)
    s_chunk = torch.einsum("bnqh,bnqhc,bnqhp->bnhcp", decay_end * dtc, bc, xc)
    chunk_gain = torch.exp(cum[:, :, -1, :])             # (B,nc,H)

    state = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=xh.device)
             if state0 is None else state0.float())
    prev = []
    for i in range(nc):                                  # emit the state BEFORE each chunk
        prev.append(state)
        state = state * chunk_gain[:, i, :, None, None] + s_chunk[:, i]
    prev_states = torch.stack(prev, dim=1)               # (B,nc,H,N,P)

    # inter-chunk: y_i += C_i . (exp(cum_i) * state_prev)
    y_inter = torch.einsum("bnqhc,bnhcp,bnqh->bnqhp", cc, prev_states, torch.exp(cum))
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, state


def init_mamba_cache(cfg, batch: int, dtype, device=None):
    """Zeroed conv tails and SSM state."""
    s, d_in, n_heads, _ = _dims(cfg)
    return {
        "conv_x": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype, device=device),
        "conv_bc": torch.zeros((batch, s.d_conv - 1, 2 * s.n_groups * s.d_state), dtype=dtype,
                               device=device),
        "ssm": torch.zeros((batch, n_heads, s.d_state, s.head_dim), dtype=dtype, device=device),
    }
