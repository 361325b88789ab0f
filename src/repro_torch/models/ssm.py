"""SSM / recurrent blocks: Mamba2 (zamba2), mLSTM + sLSTM (xlstm), as plain
PyTorch.

One chunked SSD scan (``ssd_chunk_scan``) serves both Mamba2 and mLSTM — they
share the state-space structure  S_t = a_t·S_{t-1} + dt_t·(B_t ⊗ x_t),
y_t = C_t·S_t: Mamba2 sets a = exp(dt·A); mLSTM sets (B, C, dt, a) =
(k, q, i-gate, f-gate) with an extra normalizer channel.  The scan processes
``chunk``-sized blocks: quadratic intra-chunk attention-form (stable — decay
differences only inside a chunk) + a sequential inter-chunk state carry,
keeping peak memory at O(B·L²·H) per chunk instead of O(B·S²).  State is
float32; projections run in the activations' dtype.

Decode paths are exact single-step recurrences over the carried state, O(1)
per token per layer.  They write the cache they are given in place (the
stacked cache's layer views) and return it, as the attention decode does.

Three-operand contractions are written as explicit products, so the order
of the float32 sums stays close to XLA's; a division by a Python scalar
divides by a tensor of the operand's dtype, as ``jnp`` does (PyTorch's
``tensor / float`` multiplies by a rounded reciprocal).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import apply_norm
from .schema import PSpec

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# shared chunked SSD scan
# --------------------------------------------------------------------------- #
def ssd_chunk_scan(xh, dt, bm, cm, da, chunk: int, state0):
    """xh (B,S,H,P), dt (B,S,H), bm/cm (B,S,H,N), da (B,S,H) = log-decay ≤ 0.

    Returns (y (B,S,H,P) fp32, final_state (B,H,N,P) fp32).
    """
    b, s, h, p = xh.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))

    def rs(t):  # (B, nc·L, ...) → (nc, B, L, ...)
        return t.float().reshape((b, nc, chunk) + t.shape[2:]).transpose(0, 1)

    xc, dtc, bc, cc, dac = rs(xh), rs(dt), rs(bm), rs(cm), rs(da)
    lm = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                               device=xh.device))
    state = state0.float()
    ys = []
    for ci in range(nc):
        x1, dt1, b1, c1, a1 = xc[ci], dtc[ci], bc[ci], cc[ci], dac[ci]
        cum = torch.cumsum(a1, dim=1)                   # (B,L,H)
        # intra-chunk: decay[l,m] = exp(cum_l - cum_m), m ≤ l (stable in-chunk)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,L,M,H)
        decay = torch.exp(diff.masked_fill(~lm[None, :, :, None], NEG_INF))
        cb = torch.einsum("blhn,bmhn->blmh", c1, b1)    # (B,L,M,H)
        dtx = dt1[..., None] * x1                       # (B,L,H,P)
        y_intra = torch.einsum("blmh,bmhp->blhp", cb * decay, dtx)
        # inter-chunk: carried state read
        y_inter = torch.einsum("blhn,bhnp->blhp", c1, state) * \
            torch.exp(cum)[..., None]
        # state update
        last = cum[:, -1]                               # (B,H)
        w = torch.exp(last[:, None, :] - cum)           # (B,L,H)
        state = state * torch.exp(last)[:, :, None, None] + \
            torch.einsum("blhn,blhp->bhnp", b1 * w[..., None], dtx)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, nc * chunk, h, p)[:, :s]
    return y, state


def ssd_decode_step(state, x1, dt1, b1, c1, a1):
    """Single-token recurrence.  x1 (B,H,P), dt1/a1 (B,H), b1/c1 (B,H,N).

    ``state`` (B,H,N,P) float32 is updated in place; returns (y (B,H,P),
    state)."""
    decay = torch.exp(a1.float())
    outer = (b1.float() * dt1.float()[..., None])[..., None] * \
        x1.float()[:, :, None, :]
    state.mul_(decay[:, :, None, None]).add_(outer)
    y = torch.einsum("bhn,bhnp->bhp", c1.float(), state)
    return y, state


# --------------------------------------------------------------------------- #
# causal depthwise conv (width W) + state for decode
# --------------------------------------------------------------------------- #
def causal_conv(x, w, b):
    """x (B,S,C), w (W,C) depthwise, left-padded causal."""
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s] * w[0][None, None, :]
    for i in range(1, width):
        out = out + xp[:, i: i + s] * w[i][None, None, :]
    return out + b[None, None, :]


def causal_conv_step(conv_state, x1, w, b):
    """conv_state (B, W-1, C); x1 (B, C) → (y (B,C), conv_state): the
    state shifts by one position in place."""
    full = torch.cat([conv_state, x1[:, None, :].to(conv_state.dtype)], dim=1)
    # a contraction over W summed in float32 and rounded once, as a dot
    y = (full.float() * w.float()[None]).sum(1).to(full.dtype) + b[None, :]
    conv_state.copy_(full[:, 1:])
    return y, conv_state


def _at_least_one(x):
    """``max(x, 1)`` with JAX's gradient: split evenly where ``x == 1``
    (``clamp`` would pass all of it)."""
    return torch.maximum(x, torch.ones((), dtype=x.dtype, device=x.device))


def _div(x, scalar: float):
    """``x / scalar`` as ``jnp`` computes it: the scalar rounded to ``x``'s
    dtype, then a true division."""
    return x / torch.tensor(scalar, dtype=x.dtype, device=x.device)


# --------------------------------------------------------------------------- #
# Mamba2 block
# --------------------------------------------------------------------------- #
CONV_W = 4


class MambaCache(NamedTuple):
    state: torch.Tensor    # (B, H, N, P) fp32
    conv: torch.Tensor     # (B, CONV_W-1, di + 2N)


def mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    p = cfg.ssm_head_dim
    h = di // p
    n = cfg.ssm_state_dim
    return di, h, p, n


def mamba_schema(cfg) -> dict:
    d = cfg.d_model
    di, h, p, n = mamba_dims(cfg)
    cw = di + 2 * n
    return {
        "w_in": PSpec((d, 2 * di + 2 * n + h), ("embed", "ssm_inner")),
        "conv_w": PSpec((CONV_W, cw), (None, None), "normal", 0.2),
        "conv_b": PSpec((cw,), (None,), "zeros"),
        "a_log": PSpec((h,), (None,), "zeros"),
        "dt_bias": PSpec((h,), (None,), "zeros"),
        "d_skip": PSpec((h,), (None,), "ones"),
        "norm": {"scale": PSpec((di,), ("ssm_inner",), "ones")},
        "w_out": PSpec((di, d), ("ssm_inner", "embed")),
    }


def _mamba_proj(p, cfg, x):
    di, h, _, n = mamba_dims(cfg)
    z_xbc_dt = x @ p["w_in"].to(x.dtype)
    z = z_xbc_dt[..., :di]
    xbc = z_xbc_dt[..., di: 2 * di + 2 * n]
    dt_raw = z_xbc_dt[..., 2 * di + 2 * n:]
    return z, xbc, dt_raw


def _mamba_post(p, cfg, y, z, x_dtype):
    di = mamba_dims(cfg)[0]
    y = y.reshape(y.shape[:-2] + (di,)).to(x_dtype)
    y = apply_norm(p["norm"], y * F.silu(z))
    return y @ p["w_out"].to(x_dtype)


def mamba_forward(p, cfg, x):
    """x (B,S,d) → (B,S,d)."""
    di, h, pp, n = mamba_dims(cfg)
    z, xbc, dt_raw = _mamba_proj(p, cfg, x)
    xbc = F.silu(causal_conv(xbc, p["conv_w"].to(x.dtype),
                             p["conv_b"].to(x.dtype)))
    xs, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    da = dt * a[None, None, :]
    bsz, s = x.shape[:2]
    xh = xs.reshape(bsz, s, h, pp)
    bm = bmat[:, :, None, :].expand(bsz, s, h, n)
    cm = cmat[:, :, None, :].expand(bsz, s, h, n)
    state0 = torch.zeros((bsz, h, n, pp), dtype=torch.float32,
                         device=x.device)
    y, _ = ssd_chunk_scan(xh, dt, bm, cm, da, cfg.ssm_chunk, state0)
    y = y + p["d_skip"][None, None, :, None] * xh.float()
    return _mamba_post(p, cfg, y, z, x.dtype)


def mamba_decode(p, cfg, x, cache: MambaCache):
    """x (B,1,d) single step; ``cache`` is updated in place."""
    di, h, pp, n = mamba_dims(cfg)
    z, xbc, dt_raw = _mamba_proj(p, cfg, x)
    xbc1, _ = causal_conv_step(cache.conv, xbc[:, 0],
                               p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype))
    xbc1 = F.silu(xbc1)
    xs, bmat, cmat = xbc1[..., :di], xbc1[..., di:di + n], xbc1[..., di + n:]
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    da = dt * a[None, :]
    bsz = x.shape[0]
    xh = xs.reshape(bsz, h, pp)
    bm = bmat[:, None, :].expand(bsz, h, n)
    cm = cmat[:, None, :].expand(bsz, h, n)
    y, _ = ssd_decode_step(cache.state, xh, dt, bm, cm, da)
    y = y + p["d_skip"][None, :, None] * xh.float()
    out = _mamba_post(p, cfg, y[:, None], z, x.dtype)
    return out, cache


def init_mamba_cache(cfg, batch: int, dtype, device) -> MambaCache:
    di, h, pp, n = mamba_dims(cfg)
    return MambaCache(
        torch.zeros((batch, h, n, pp), dtype=torch.float32, device=device),
        torch.zeros((batch, CONV_W - 1, di + 2 * n), dtype=dtype,
                    device=device))


# --------------------------------------------------------------------------- #
# mLSTM block (xlstm) — linear attention with exp input / sigmoid forget gate
# --------------------------------------------------------------------------- #
class MLSTMCache(NamedTuple):
    state: torch.Tensor    # (B, H, DK, DV+1) — last column is the normalizer
    conv: torch.Tensor     # (B, CONV_W-1, di)


def mlstm_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    h = cfg.num_heads
    dk = di // h
    return di, h, dk


def mlstm_schema(cfg) -> dict:
    d = cfg.d_model
    di, h, dk = mlstm_dims(cfg)
    return {
        "w_up": PSpec((d, 2 * di), ("embed", "ssm_inner")),
        "conv_w": PSpec((CONV_W, di), (None, None), "normal", 0.2),
        "conv_b": PSpec((di,), (None,), "zeros"),
        "wq": PSpec((di, di), ("ssm_inner", None)),
        "wk": PSpec((di, di), ("ssm_inner", None)),
        "wv": PSpec((di, di), ("ssm_inner", None)),
        "w_igate": PSpec((di, h), (None, None), "normal", 0.05),
        "b_igate": PSpec((h,), (None,), "zeros"),
        "w_fgate": PSpec((di, h), (None, None), "normal", 0.05),
        "b_fgate": PSpec((h,), (None,), "ones"),
        "norm": {"scale": PSpec((di,), ("ssm_inner",), "ones")},
        "w_down": PSpec((di, d), ("ssm_inner", "embed")),
    }


def _mlstm_gates(p, xc, dtype):
    """Exponential input gate (clamped for stability), log of the sigmoid
    forget gate, both float32."""
    ig = xc @ p["w_igate"].to(dtype) + p["b_igate"].to(dtype)
    fg = xc @ p["w_fgate"].to(dtype) + p["b_fgate"].to(dtype)
    return (torch.exp(torch.clamp(ig.float(), -8.0, 8.0)),
            F.logsigmoid(fg.float()))


def _mlstm_qkvif(p, cfg, x):
    di, h, dk = mlstm_dims(cfg)
    up = x @ p["w_up"].to(x.dtype)
    xm, z = up[..., :di], up[..., di:]
    xc = F.silu(causal_conv(xm, p["conv_w"].to(x.dtype),
                            p["conv_b"].to(x.dtype)))
    shp = x.shape[:-1] + (h, dk)
    q = _div((xc @ p["wq"].to(x.dtype)).reshape(shp), dk ** 0.5)
    k = (xc @ p["wk"].to(x.dtype)).reshape(shp)
    v = (xm @ p["wv"].to(x.dtype)).reshape(shp)
    i_gate, log_f = _mlstm_gates(p, xc, x.dtype)
    return q, k, v, i_gate, log_f, z, xm


def _mlstm_read(y_aug, z, p, cfg, x_dtype):
    di = mlstm_dims(cfg)[0]
    num, den = y_aug[..., :-1], y_aug[..., -1:]
    y = num / _at_least_one(torch.abs(den))
    y = y.reshape(y.shape[:-2] + (di,)).to(x_dtype)
    y = apply_norm(p["norm"], y) * F.silu(z)
    return y @ p["w_down"].to(x_dtype)


def _ones_channel(v):
    """v with a ones channel: the normalizer recurrence rides along."""
    return torch.cat([v.float(), torch.ones(v.shape[:-1] + (1,),
                                            dtype=torch.float32,
                                            device=v.device)], -1)


def mlstm_forward(p, cfg, x):
    di, h, dk = mlstm_dims(cfg)
    bsz = x.shape[0]
    q, k, v, ig, log_f, z, _ = _mlstm_qkvif(p, cfg, x)
    state0 = torch.zeros((bsz, h, dk, dk + 1), dtype=torch.float32,
                         device=x.device)
    y_aug, _ = ssd_chunk_scan(_ones_channel(v), ig, k, q, log_f,
                              cfg.ssm_chunk, state0)
    return _mlstm_read(y_aug, z, p, cfg, x.dtype)


def mlstm_decode(p, cfg, x, cache: MLSTMCache):
    """x (B,1,d) single step; ``cache`` is updated in place."""
    di, h, dk = mlstm_dims(cfg)
    bsz = x.shape[0]
    up = x @ p["w_up"].to(x.dtype)
    xm, z = up[..., :di], up[..., di:]
    xc1, _ = causal_conv_step(cache.conv, xm[:, 0], p["conv_w"].to(x.dtype),
                              p["conv_b"].to(x.dtype))
    xc1 = F.silu(xc1)
    q = _div((xc1 @ p["wq"].to(x.dtype)).reshape(bsz, h, dk), dk ** 0.5)
    k = (xc1 @ p["wk"].to(x.dtype)).reshape(bsz, h, dk)
    v = (xm[:, 0] @ p["wv"].to(x.dtype)).reshape(bsz, h, dk)
    ig, log_f = _mlstm_gates(p, xc1, x.dtype)
    y_aug, _ = ssd_decode_step(cache.state, _ones_channel(v), ig, k, q,
                               log_f)
    out = _mlstm_read(y_aug[:, None], z, p, cfg, x.dtype)
    return out, cache


def init_mlstm_cache(cfg, batch: int, dtype, device) -> MLSTMCache:
    di, h, dk = mlstm_dims(cfg)
    return MLSTMCache(
        torch.zeros((batch, h, dk, dk + 1), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, CONV_W - 1, di), dtype=dtype, device=device))


# --------------------------------------------------------------------------- #
# sLSTM block (xlstm) — recurrent scalar LSTM with exponential gating
# --------------------------------------------------------------------------- #
class SLSTMCache(NamedTuple):
    c: torch.Tensor   # (B, H, dh) fp32
    n: torch.Tensor
    m: torch.Tensor
    h: torch.Tensor


def slstm_dims(cfg):
    h = cfg.num_heads
    dh = cfg.d_model // h
    return h, dh


def slstm_schema(cfg) -> dict:
    d = cfg.d_model
    h, dh = slstm_dims(cfg)
    ffd = max(8, int(d * 4 // 3))
    return {
        "w_x": PSpec((d, 4 * d), ("embed", None)),
        "r_h": PSpec((h, dh, 4 * dh), (None, None, None), "normal", 0.05),
        "b": PSpec((4 * d,), (None,), "zeros"),
        "norm": {"scale": PSpec((d,), ("embed",), "ones")},
        "w_ff1": PSpec((d, ffd), ("embed", "ff")),
        "w_ff2": PSpec((ffd, d), ("ff", "embed")),
    }


def _slstm_cell(carry: SLSTMCache, gx, r_h) -> SLSTMCache:
    """gx: (B, H, dh, 4) pre-activations from x; recurrent part added here.
    Returns the new carry (its ``h`` is the cell's output)."""
    c, n, m, hprev = carry
    rec = torch.einsum("bhd,hdk->bhk", hprev, r_h).reshape(gx.shape)
    g = (gx + rec).float()
    gi, gf, gz, go = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    fm = gf + m
    m_new = torch.maximum(fm, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(fm - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    # no gradient is taken through the cell (``_SLSTMScan`` has its own)
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMCache(c_new, n_new, m_new, h_new)


def _slstm_out(p, y):
    y = apply_norm(p["norm"], y)
    h = F.gelu(y @ p["w_ff1"].to(y.dtype), approximate="tanh")
    return h @ p["w_ff2"].to(y.dtype)


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over a sequence as one autograd node.

    The forward runs ``_slstm_cell`` step by step with nothing recorded and
    keeps the carries; the backward recomputes every step's gates in bulk
    from them and runs the reverse recurrence by hand.  Recording every
    cell op instead makes each an autograd node (and, under remat, a
    saved-tensor hook), which on a card costs more host time than the
    kernels take.  The forward is the cell's arithmetic; the gradient is
    the same function's, summed in another order, with JAX's even split at
    a ``max`` tie.
    """

    @staticmethod
    def forward(ctx, gx, r_h):
        """gx (B,S,H,dh,4) float32, the gates' input part with its bias;
        r_h (H,dh,4dh) float32.  Returns h (B,S,H,dh)."""
        b, s, h, dh, _ = gx.shape
        zero = gx.new_zeros((b, h, dh))
        carry = SLSTMCache(zero, zero, zero, zero)
        states = [carry]
        for t in range(s):
            carry = _slstm_cell(carry, gx[:, t], r_h)
            states.append(carry)
        c, n, m, hh = (torch.stack(x, dim=1) for x in zip(*states))
        ctx.save_for_backward(gx, r_h, c, n, m, hh)
        return hh[:, 1:]

    @staticmethod
    def backward(ctx, dhs):
        gx, r_h, c, n, m, hh = ctx.saved_tensors
        b, s, h, dh, _ = gx.shape
        # every step's gates at once, from the carries (the cell's ops)
        g = gx + torch.einsum("bshd,hdk->bshk", hh[:, :-1], r_h).reshape(
            gx.shape)
        gi, gf, gz, go = g.unbind(-1)
        fm = gf + m[:, :-1]
        i = torch.exp(gi - m[:, 1:])
        f = torch.exp(fm - m[:, 1:])
        tz = torch.tanh(gz)
        so = torch.sigmoid(go)
        c_new, n_new = c[:, 1:], n[:, 1:]
        nc = torch.clamp(n_new, min=1.0)
        half = lambda a, b_: (a > b_).float() + 0.5 * (a == b_).float()
        d_h_c = so / nc                                   # ∂h'/∂c'
        d_h_n = -so * c_new / (nc * nc) * half(n_new, 1.0)  # ∂h'/∂n'
        d_h_go = c_new / nc * so * (1 - so)               # ∂h'/∂go
        d_c_gz = i * (1 - tz * tz)                        # ∂c'/∂gz
        to_fm = half(fm, gi)                              # ∂m'/∂fm
        to_gi = 1 - to_fm                                 # ∂m'/∂gi
        c_prev, n_prev = c[:, :-1], n[:, :-1]
        d_g = torch.empty_like(gx)
        zero = gx.new_zeros((b, h, dh))
        dc_n, dn_n, dm_n, dh_n = zero, zero, zero, zero   # from step t + 1
        for t in reversed(range(s)):
            d_h = dhs[:, t] + dh_n
            dc = dc_n + d_h * d_h_c[:, t]
            dn = dn_n + d_h * d_h_n[:, t]
            u = (dc * tz[:, t] + dn) * i[:, t]            # ∂/∂(gi − m')
            w = (dc * c_prev[:, t] + dn * n_prev[:, t]) * f[:, t]
            dm = dm_n - u - w                             # ∂/∂m'
            dfm = w + dm * to_fm[:, t]
            d_g[:, t] = torch.stack([u + dm * to_gi[:, t], dfm,
                                     dc * d_c_gz[:, t],
                                     d_h * d_h_go[:, t]], dim=-1)
            dc_n, dn_n, dm_n = dc * f[:, t], dn * f[:, t], dfm
            dh_n = torch.einsum("bhk,hdk->bhd",
                                d_g[:, t].reshape(b, h, 4 * dh), r_h)
        d_r = torch.einsum("bshd,bshk->hdk", hh[:, :-1],
                           d_g.reshape(b, s, h, 4 * dh))
        return d_g, d_r


def slstm_forward(p, cfg, x):
    h, dh = slstm_dims(cfg)
    bsz, s, d = x.shape
    gx = (x @ p["w_x"].to(x.dtype)).reshape(bsz, s, h, dh, 4).float()
    gx = gx + p["b"].float().reshape(h, dh, 4)
    hs = _SLSTMScan.apply(gx, p["r_h"].float())
    return _slstm_out(p, hs.reshape(bsz, s, d).to(x.dtype))


def slstm_decode(p, cfg, x, cache: SLSTMCache):
    """x (B,1,d) single step; ``cache`` is updated in place."""
    h, dh = slstm_dims(cfg)
    bsz, _, d = x.shape
    gx = (x[:, 0] @ p["w_x"].to(x.dtype)).reshape(bsz, h, dh, 4)
    new = _slstm_cell(cache, gx.float() + p["b"].float().reshape(h, dh, 4),
                      p["r_h"].float())
    for dst, src in zip(cache, new):
        dst.copy_(src)
    y = new.h.reshape(bsz, 1, d).to(x.dtype)
    return _slstm_out(p, y), cache


def init_slstm_cache(cfg, batch: int, dtype, device) -> SLSTMCache:
    h, dh = slstm_dims(cfg)
    return SLSTMCache(*(torch.zeros((batch, h, dh), dtype=torch.float32,
                                    device=device) for _ in range(4)))
