"""xLSTM blocks (arXiv:2405.04517), as in ``repro/models/xlstm.py``:
mLSTM (matrix memory, parallelisable) and sLSTM (scalar memory,
inherently sequential).

mLSTM runs in the chunkwise-parallel form: within a chunk a masked
quadratic product; across chunks a [dk, dv] matrix state and a [dk]
normaliser carried from chunk to chunk (the JAX package's ``lax.scan``
is a Python loop over the chunks).  Decode is the single-step
recurrence.  sLSTM uses exponential gating with the max-stabiliser state
and a per-head recurrent kernel, one step a token.  The JAX package
runs both outside any Pallas kernel, so the port runs them as plain
torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import softplus
from repro_torch.models.sharding import batch_local, maybe_shard


# ----------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------

def mlstm_chunkwise(q, k, v, log_f, log_i, *, chunk: int = 256,
                    state0=None, return_state: bool = False):
    """q, k, v: [B, T, H, D]; log_f / log_i: [B, T, H] (f32 log gates).

    Returns [B, T, H, D] (and the final (S [B, H, D, D], n [B, H, D]) if
    asked).  When T is not a multiple of ``chunk`` the whole sequence is
    one chunk, as in the JAX package."""
    b, t, h, d = q.shape
    if t % chunk != 0:
        chunk = t
    scale = d ** -0.5
    dev = q.device
    S = (torch.zeros((b, h, d, d), dtype=torch.float32, device=dev)
         if state0 is None else state0[0])
    n = (torch.zeros((b, h, d), dtype=torch.float32, device=dev)
         if state0 is None else state0[1])
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dev))
    outs = []
    for c0 in range(0, t, chunk):
        qi, ki, vi = (a[:, c0:c0 + chunk] for a in (q, k, v))
        lf, li = log_f[:, c0:c0 + chunk], log_i[:, c0:c0 + chunk]
        F_ = torch.cumsum(lf, dim=1)                   # [B, c, H]
        # Intra-chunk: A[t, s] = exp(F_t - F_s + li_s), s <= t.
        logA = F_[:, :, None, :] - F_[:, None, :, :] + li[:, None, :, :]
        logA = torch.where(causal[None, :, :, None], logA, -torch.inf)
        A = torch.exp(logA)                            # [B, c, c, H]
        sc = torch.einsum("bthd,bshd->btsh", qi, ki).float() * scale
        intra = torch.einsum("btsh,bshd->bthd", sc * A, vi.float())
        n_intra = torch.einsum("btsh,bshd->bthd", A, ki.float())
        # Inter-chunk: the carried state read with decay exp(F_t).
        decay_t = torch.exp(F_)                        # [B, c, H]
        q32 = qi.float() * scale
        inter = torch.einsum("bthd,bhde->bthe", q32, S) * decay_t[..., None]
        n_inter = torch.einsum("bthd,bhd->bth", q32, n) * decay_t
        # Normalised hidden state: h = num / max(|n q|, 1).
        num = intra + inter
        den = torch.abs(torch.einsum("bthd,bthd->bth", q32, n_intra)
                        + n_inter)
        outs.append((num / torch.clamp(den, min=1.0)[..., None]).to(q.dtype))
        # State: S' = exp(F_C) S + sum_s exp(F_C - F_s + li_s) k v^T.
        F_C = F_[:, -1][:, None]                       # [B, 1, H]
        w_s = torch.exp(F_C - F_ + li)                 # [B, c, H]
        kw = ki.float() * w_s[..., None]
        decay_c = torch.exp(F_C[:, 0])                 # [B, H]
        S = S * decay_c[..., None, None] + torch.einsum(
            "bshd,bshe->bhde", kw, vi.float())
        n = n * decay_c[..., None] + kw.sum(dim=1)
    out = torch.cat(outs, dim=1)
    if return_state:
        return out, (S, n)
    return out


def mlstm_step(q, k, v, log_f, log_i, state):
    """Single decode step. q, k, v: [B, H, D]; gates [B, H]; state (S, n)."""
    S, n = state
    f = torch.exp(log_f.float())[..., None, None]
    i = torch.exp(log_i.float())[..., None, None]
    k32, v32, q32 = k.float(), v.float(), q.float()
    q32 = q32 * (q.shape[-1] ** -0.5)
    S_new = f * S + i * k32[..., :, None] * v32[..., None, :]
    n_new = f[..., 0] * n + i[..., 0] * k32
    num = torch.einsum("bhd,bhde->bhe", q32, S_new)
    den = torch.abs(torch.einsum("bhd,bhd->bh", q32, n_new))
    out = num / torch.clamp(den, min=1.0)[..., None]
    return out.to(q.dtype), (S_new, n_new)


def mlstm_block(x, params, cfg, *, state=None, return_state: bool = False):
    """xLSTM mLSTM block: up-projection (2x), q/k/v heads, gated output,
    down-projection.  x: [B, T, d_model]."""
    b, t, _ = x.shape
    h = cfg.n_heads
    d_in = params["w_up_x"].shape[1]
    dh = d_in // h
    xm = x @ params["w_up_x"]
    z = x @ params["w_up_z"]
    xm = maybe_shard(xm, "dp", None, None)
    q = (xm @ params["w_q"]).reshape(b, t, h, dh)
    k = (xm @ params["w_k"]).reshape(b, t, h, dh)
    v = (xm @ params["w_v"]).reshape(b, t, h, dh)
    # log sigmoid in f32: F.logsigmoid's min(x, 0) - log1p(exp(-|x|)) is
    # JAX's -softplus(-x) term for term.
    log_f = F.logsigmoid((xm @ params["w_f"]).float() + params["b_f"])
    log_i = (xm @ params["w_i"]).float() + params["b_i"]
    log_i = -softplus(-log_i)
    if t == 1 and state is not None:
        out, st = mlstm_step(q[:, 0], k[:, 0], v[:, 0],
                             log_f[:, 0], log_i[:, 0], state)
        out = out[:, None]
    else:
        res = mlstm_chunkwise(q, k, v, log_f, log_i, state0=state,
                              return_state=return_state)
        out, st = res if return_state else (res, None)
    out = out.reshape(b, t, d_in) * F.silu(z)
    y = out @ params["w_down"]
    if return_state:
        return y, st
    return y


# ----------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------

def slstm_init_state(b: int, d: int, dtype, device):
    """(h in the activations' dtype, c, n f32 zeros, m f32 at -1e30)."""
    f32 = torch.float32
    return (torch.zeros((b, d), dtype=dtype, device=device),
            torch.zeros((b, d), dtype=f32, device=device),
            torch.zeros((b, d), dtype=f32, device=device),
            torch.full((b, d), -1e30, dtype=f32, device=device))


def slstm_scan(x, params, state0=None, return_state: bool = False):
    """x: [B, T, D]. Per-head recurrent kernel R [H, Dh, 4*Dh].

    Exponential gating with the stabiliser m (xLSTM eq. 15), one step a
    token.  The carried h has x's dtype.  A state whose h has another
    dtype raises ``TypeError``, as ``lax.scan`` refuses a carry that
    changes type (the JAX package's decode with f32 params and its bf16
    cache)."""
    b, t, d = x.shape
    r = params["r_kernel"]
    h_heads, dh, _ = r.shape
    if state0 is None:
        state0 = slstm_init_state(b, d, x.dtype, x.device)
    elif state0[0].dtype != x.dtype:
        raise TypeError(
            f"slstm_scan: the carried h is {state0[0].dtype} but the step "
            f"makes {x.dtype}: scan body function carry input and carry "
            "output must have equal types (the JAX package's decode runs "
            "the sLSTM in the cache's bf16 only)")
    zx = x @ params["w_zifo"]                          # [B, T, 4D]
    h_prev, c_prev, n_prev, m_prev = state0
    ys = []
    for s in range(t):
        hh = h_prev.reshape(b, h_heads, dh)
        rec = torch.einsum("bhd,hde->bhe", hh, r).reshape(b, 4 * d)
        pre = (zx[:, s] + rec).float()
        z, i, f, o = torch.split(pre, d, dim=-1)
        z = torch.tanh(z)
        o = torch.sigmoid(o)
        log_f = F.logsigmoid(f)                        # -softplus(-f), f32
        m_new = torch.maximum(log_f + m_prev, i)
        i_p = torch.exp(i - m_new)
        f_p = torch.exp(log_f + m_prev - m_new)
        c_prev = f_p * c_prev + i_p * z
        n_prev = f_p * n_prev + i_p
        h_prev = (o * (c_prev / torch.clamp(n_prev, min=1.0))).to(x.dtype)
        m_prev = m_new
        ys.append(h_prev)
    out = torch.stack(ys, dim=1)
    if return_state:
        return out, (h_prev, c_prev, n_prev, m_prev)
    return out


def slstm_block(x, params, cfg, *, state=None, return_state: bool = False):
    """sLSTM block and its gated (4/3) FFN, as in xLSTM's sLSTM block.
    Under a mesh the scan runs on each device's rows
    (``sharding.batch_local``)."""
    def scan(x, *rest):
        w_zifo, r_kernel, *st0 = rest[-2:] + rest[:-2]
        return slstm_scan(x, {"w_zifo": w_zifo, "r_kernel": r_kernel},
                          state0=tuple(st0) or None, return_state=True)

    y, st = batch_local(scan, (x, *(state or ())),
                        (params["w_zifo"], params["r_kernel"]))
    y = y @ params["w_proj"]
    g = y @ params["w_ff_gate"]
    y = (F.gelu(g, approximate="tanh") * (y @ params["w_ff_up"])
         ) @ params["w_ff_down"]
    if return_state:
        return y, st
    return y
