"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential scan).

Counterpart of ``repro/models/xlstm.py``.  mLSTM per head (d_k keys, d_v
values), exponential gating with a stabilizer:

    m_t = max(f̃_t + m_{t-1}, ĩ_t)
    f'_t = exp(f̃_t + m_{t-1} - m_t),  i'_t = exp(ĩ_t - m_t)
    C_t = f'_t C_{t-1} + i'_t v_t k_tᵀ        n_t = f'_t n_{t-1} + i'_t k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)

A forward runs the chunkwise-parallel form (a loop over chunks, each an
(L, L) decay matrix and a few products); a decode step runs the O(1)
recurrent step.  Both cells compute in float32 (at least), whatever the
model's dtype, and so do the sLSTM's scan and its block-diagonal
recurrent matrices ``r_*`` (H, W/H, W/H) and the mLSTM's gate projection
``w_if``.  No cell here has a kernel of its own: the reference has no
Pallas kernel for them either, and the products go to cuBLAS.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _dense_init, draw_device
from repro_torch.models.rglru import _causal_conv

Tensor = torch.Tensor
MState = Tuple[Tensor, Tensor, Tensor]            # (C, n, m)


def _cell_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


# ---------------------------------------------------------------------------
# mLSTM cell — chunkwise parallel + recurrent step
# ---------------------------------------------------------------------------

def mlstm_chunkwise(q: Tensor, k: Tensor, v: Tensor, logf: Tensor,
                    logi: Tensor, chunk: int,
                    state: Optional[MState] = None
                    ) -> Tuple[Tensor, MState]:
    """q/k: (B, H, S, dk); v: (B, H, S, dv); logf/logi: (B, H, S).  S must
    be a multiple of ``chunk`` (no padding, as in the reference).

    Returns (h: (B, H, S, dv), final state (C, n, m)).
    """
    b, nh, s, dk = q.shape
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM "
                         f"chunk {chunk}")
    if state is None:
        cdt = _cell_dtype(q.dtype)
        C = torch.zeros((b, nh, dk, v.shape[-1]), dtype=cdt, device=q.device)
        n = torch.zeros((b, nh, dk), dtype=cdt, device=q.device)
        m = torch.full((b, nh), -1e30, dtype=cdt, device=q.device)
    else:
        C, n, m = state
    scale = dk ** -0.5
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    hs = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, lf, li = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            logf[:, :, sl], logi[:, :, sl]
        bcum = torch.cumsum(lf, -1)                             # (B,H,L)
        # intra-chunk log-decay D[t,s] = bcum_t - bcum_s + li_s (s ≤ t)
        ldec = bcum[..., :, None] - bcum[..., None, :] + li[..., None, :]
        ldec = ldec.masked_fill(~tri, float("-inf"))
        # stabilizers
        m_intra = ldec.amax(-1)                                 # (B,H,L)
        m_inter = bcum + m[..., None]
        m_t = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)

        dec = torch.exp(ldec - m_t[..., None])                  # (B,H,L,L)
        inter_w = torch.exp(m_inter - m_t)                      # (B,H,L)

        s_qk = (qc @ kc.transpose(-1, -2)) * scale
        h_num = (s_qk * dec) @ vc + inter_w[..., None] * (qc @ C) * scale
        # normalizer state at t: decayed k-sum (no q): intra + carried n
        n_t = dec @ kc + inter_w[..., None] * n[:, :, None, :]
        qn = (qc * n_t).sum(-1) * scale
        denom = torch.maximum(qn.abs(), torch.exp(-m_t))
        hs.append(h_num / denom[..., None])

        # chunk-final state
        lf_total = bcum[..., -1]                                # (B,H)
        tail = lf_total[..., None] - bcum + li
        m_new = torch.maximum(lf_total + m, tail.amax(-1))
        w_old = torch.exp(lf_total + m - m_new)                 # (B,H)
        w_s = torch.exp(tail - m_new[..., None])                # (B,H,L)
        C = w_old[..., None, None] * C \
            + (w_s[..., None] * kc).transpose(-1, -2) @ vc
        n = w_old[..., None] * n + (w_s[..., None] * kc).sum(-2)
        m = m_new
    return torch.cat(hs, 2), (C, n, m)


def mlstm_step(q: Tensor, k: Tensor, v: Tensor, logf: Tensor, logi: Tensor,
               state: MState) -> Tuple[Tensor, MState]:
    """Single decode step.  q/k: (B,H,dk); v: (B,H,dv); logf/logi: (B,H).
    Returns (h (B,H,dv), new state); the state passed in is not written."""
    C, n, m = state
    scale = q.shape[-1] ** -0.5
    m_new = torch.maximum(logf + m, logi)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(logi - m_new)
    C_new = fp[..., None, None] * C \
        + ip[..., None, None] * (k[..., :, None] * v[..., None, :])
    n_new = fp[..., None] * n + ip[..., None] * k
    num = (q[..., None, :] @ C_new)[..., 0, :] * scale
    qn = (q * n_new).sum(-1) * scale
    denom = torch.maximum(qn.abs(), torch.exp(-m_new))
    return num / denom[..., None], (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM cell — strictly sequential scalar memory
# ---------------------------------------------------------------------------

def slstm_scan(z: Tensor, i_in: Tensor, f_in: Tensor, o_in: Tensor,
               r_z: Tensor, r_i: Tensor, r_f: Tensor, r_o: Tensor,
               state: Optional[Tuple[Tensor, ...]] = None
               ) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    """Inputs: (B, S, W) pre-activations; r_*: (H, W/H, W/H) block-diagonal
    recurrent weights.  Returns (h: (B, S, W) in z's dtype, final state
    (c, n, h, m)), a loop over S in float32 (at least)."""
    b, s, w = z.shape
    nh = r_z.shape[0]
    cdt = _cell_dtype(z.dtype)
    if state is None:
        c = torch.zeros((b, w), dtype=cdt, device=z.device)
        n = torch.ones((b, w), dtype=cdt, device=z.device)
        h = torch.zeros((b, w), dtype=cdt, device=z.device)
        m = torch.zeros((b, w), dtype=cdt, device=z.device)
    else:
        c, n, h, m = state

    def rmat(h, r):
        return torch.einsum("bhw,hwu->bhu", h.reshape(b, nh, w // nh),
                            r).reshape(b, w)

    out_dtype = z.dtype
    z, i_in, f_in, o_in = (a.to(cdt) for a in (z, i_in, f_in, o_in))
    hs = []
    for t in range(s):
        zt = torch.tanh(z[:, t] + rmat(h, r_z))
        it = i_in[:, t] + rmat(h, r_i)
        ft = f_in[:, t] + rmat(h, r_f)
        ot = torch.sigmoid(o_in[:, t] + rmat(h, r_o))
        m_new = torch.maximum(ft + m, it)
        ip = torch.exp(it - m_new)
        fp = torch.exp(ft + m - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        h = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    return torch.stack(hs, 1).to(out_dtype), (c, n, h, m)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(up width, dk, dv) of an mLSTM block: up = 2·d_model, dk = up/H/2,
    dv = up/H."""
    up = 2 * cfg.d_model
    return up, up // cfg.n_heads // 2, up // cfg.n_heads


def init_mlstm_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     lead: Tuple[int, ...] = (), device=None) -> dict:
    d, nh, dev = cfg.d_model, cfg.n_heads, draw_device(gen, device)
    up, dk, _ = mlstm_dims(cfg)
    return {
        "w_up": _dense_init(gen, lead + (d, up), dtype, d, dev),
        "w_gate": _dense_init(gen, lead + (d, up), dtype, d, dev),
        "conv_w": _dense_init(gen, lead + (cfg.conv_width, up), dtype,
                              cfg.conv_width, dev),
        "conv_b": torch.zeros(lead + (up,), dtype=dtype, device=dev),
        "w_q": _dense_init(gen, lead + (up, nh, dk), dtype, up, dev),
        "w_k": _dense_init(gen, lead + (up, nh, dk), dtype, up, dev),
        "w_if": _dense_init(gen, lead + (up, nh, 2), torch.float32, up,
                            dev),
        "w_down": _dense_init(gen, lead + (up, d), dtype, up, dev),
        "skip_scale": torch.ones(lead + (up,), dtype=dtype, device=dev),
    }


def _heads(x: Tensor, w: Tensor) -> Tensor:
    """(B, S, U) @ (U, H, k) → (B, H, S, k), one matmul."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(
        b, s, w.shape[1], w.shape[2]).transpose(1, 2)


def apply_mlstm_block(p: dict, cfg: ModelConfig, x: Tensor, state=None, *,
                      decode: bool = False):
    """x: (B, S, D) → (y, new state).  ``state``: (conv_state, (C, n, m))
    carried into a prefill or, with ``decode``, a single step (S = 1);
    the new state is None without one.  The state passed in is not
    written."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    up, _, dv = mlstm_dims(cfg)

    xu = x @ p["w_up"]
    z = x @ p["w_gate"]
    conv_state = state[0] if state is not None else None
    xc, new_conv = _causal_conv(xu, p["conv_w"], p["conv_b"], conv_state)
    xc = F.silu(xc)

    f32 = torch.float32
    q = _heads(xc, p["w_q"]).to(f32)
    k = _heads(xc, p["w_k"]).to(f32)
    v = xu.view(b, s, nh, dv).transpose(1, 2).to(f32)
    gates = _heads(xc.to(f32), p["w_if"])                      # (B,H,S,2)
    logi = gates[..., 0]
    logf = F.logsigmoid(gates[..., 1])

    cell_state = state[1] if state is not None else None
    if decode:
        if s != 1:
            raise ValueError(f"an mLSTM decode step takes one token, got {s}")
        h, new_cell = mlstm_step(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                 logf[:, :, 0], logi[:, :, 0], cell_state)
        h = h[:, :, None, :]
    else:
        h, new_cell = mlstm_chunkwise(q, k, v, logf, logi,
                                      min(cfg.mlstm_chunk, s), cell_state)

    h = h.to(xu.dtype).transpose(1, 2).reshape(b, s, up)
    h = h + xc * p["skip_scale"]
    y = (h * F.silu(z)) @ p["w_down"]
    return y, ((new_conv, new_cell) if state is not None else None)


def init_slstm_block(gen: torch.Generator, cfg: ModelConfig, dtype,
                     lead: Tuple[int, ...] = (), device=None) -> dict:
    d, nh, dev = cfg.d_model, cfg.n_heads, draw_device(gen, device)
    wh = d // nh
    p = {"w_in": _dense_init(gen, lead + (d, 4 * d), dtype, d, dev)}
    for name in ("r_z", "r_i", "r_f", "r_o"):
        p[name] = _dense_init(gen, lead + (nh, wh, wh), torch.float32, wh,
                              dev)
    # post-cell projection
    p["w_out"] = _dense_init(gen, lead + (d, d), dtype, d, dev)
    return p


def apply_slstm_block(p: dict, cfg: ModelConfig, x: Tensor, state=None):
    """x: (B, S, D) → (y, new state (c, n, h, m) or None without
    ``state``).  The state passed in is not written."""
    z, i_in, f_in, o_in = torch.chunk(x @ p["w_in"], 4, -1)
    h, new_state = slstm_scan(z, i_in, f_in, o_in, p["r_z"], p["r_i"],
                              p["r_f"], p["r_o"], state)
    y = h.to(x.dtype) @ p["w_out"]
    return y, (new_state if state is not None else None)


def init_mlstm_state(cfg: ModelConfig, batch: int, dtype,
                     lead: Tuple[int, ...] = (), device=None):
    """(conv (…, B, K−1, up) in the model dtype, (C (…, B, H, dk, dv), n
    (…, B, H, dk), m (…, B, H) filled with −1e30) in float32)."""
    up, dk, dv = mlstm_dims(cfg)
    nh = cfg.n_heads
    f32 = torch.float32
    conv = torch.zeros(lead + (batch, cfg.conv_width - 1, up), dtype=dtype,
                       device=device)
    cell = (torch.zeros(lead + (batch, nh, dk, dv), dtype=f32, device=device),
            torch.zeros(lead + (batch, nh, dk), dtype=f32, device=device),
            torch.full(lead + (batch, nh), -1e30, dtype=f32, device=device))
    return (conv, cell)


def init_slstm_state(cfg: ModelConfig, batch: int,
                     lead: Tuple[int, ...] = (), device=None):
    """(c, n, h, m), each (…, B, d_model) float32; n is ones."""
    shape, f32 = lead + (batch, cfg.d_model), torch.float32
    return (torch.zeros(shape, dtype=f32, device=device),
            torch.ones(shape, dtype=f32, device=device),
            torch.zeros(shape, dtype=f32, device=device),
            torch.zeros(shape, dtype=f32, device=device))
