"""RWKV-6 "Finch" (arXiv:2404.05892), port of ``repro/models/rwkv6.py``:
token shift with a data-dependent lerp, the WKV6 linear recurrence with a
per-channel data-dependent decay, and the channel-mix FFN.

A sequence runs the reference's chunked linear-attention form: within a
chunk the pairwise decays are two matmuls, across chunks the state is
carried by a loop over the chunks.  The chunk (``CHUNK``), the decay clamp
and the order of the ``exp(cumsum)`` factors are the reference's, so the
rounding is too; a token-by-token scan would compute the same function
with other rounding.  Decode is the O(1)-state recurrent step.

Numerics: the per-step log-decay is clamped to >= LOG_W_MIN so the
within-chunk factors exp(+/- cumsum(logw)) stay inside f32 range for CHUNK
steps.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .common import LinearCtx, linear

LORA_R = 32      # token-shift ddlerp LoRA rank
DECAY_R = 64     # decay LoRA rank
CHUNK = 16
LOG_W_MIN = -4.5  # with CHUNK=16: exp(-(C-1)*LOG_W_MIN) ~ e^67.5 < f32 max


@dataclasses.dataclass
class RWKVState:
    """Per-layer recurrent state for decode (a slot per row in the paged
    pool, written in place there)."""
    s: torch.Tensor          # (B, H, dk, dv) wkv state
    x_prev_tm: torch.Tensor  # (B, d) last token input to time-mix
    x_prev_cm: torch.Tensor  # (B, d) last token input to channel-mix

    @staticmethod
    def init(b: int, h: int, dk: int, d: int, dtype=torch.float32,
             device=None) -> "RWKVState":
        return RWKVState(
            s=torch.zeros((b, h, dk, dk), dtype=torch.float32, device=device),
            x_prev_tm=torch.zeros((b, d), dtype=dtype, device=device),
            x_prev_cm=torch.zeros((b, d), dtype=dtype, device=device))


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor):
    """Data-dependent lerp mixes for (r, k, v, w, g): RWKV6 token shift."""
    d = x.shape[-1]
    base = x + xx * p["mu_x"]
    low = torch.tanh(torch.einsum("...d,dr->...r", base,
                                  p["tm_w1"].reshape(d, 5 * LORA_R)))
    low = low.reshape(*x.shape[:-1], 5, LORA_R)
    dyn = torch.einsum("...fr,frd->...fd", low, p["tm_w2"])    # (..., 5, d)
    mix = p["mu_rkvwg"] + dyn
    return [x + xx * mix[..., i, :] for i in range(5)]


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log-decay: logw = -exp(w0 + lora(xw)), clamped."""
    lora = torch.einsum("...r,rd->...d",
                        torch.tanh(torch.einsum("...d,dr->...r", xw,
                                                p["dw_a"])),
                        p["dw_b"])
    logw = -torch.exp((p["w0"] + lora).to(torch.float32))
    return torch.clamp(logw, LOG_W_MIN, -1e-6)


def _project_rkvg(p: dict, xs, ctx, name):
    xr, xk, xv, xw, xg = xs
    r = linear(p["wr"], xr, ctx, f"{name}.wr")
    k = linear(p["wk"], xk, ctx, f"{name}.wk")
    v = linear(p["wv"], xv, ctx, f"{name}.wv")
    g = F.silu(linear(p["wg"], xg, ctx, f"{name}.wg"))
    logw = _decay(p, xw)
    return r, k, v, g, logw


def _out_proj(p: dict, out: torch.Tensor, g: torch.Tensor, ctx,
              name) -> torch.Tensor:
    """Per-head group norm -> gate -> output projection."""
    b, s, d = out.shape
    nh = p["u"].shape[0]
    oh = out.to(torch.float32).reshape(b, s, nh, d // nh)
    mu = torch.mean(oh, dim=-1, keepdim=True)
    var = torch.mean(torch.square(oh - mu), dim=-1, keepdim=True)
    oh = (oh - mu) * torch.rsqrt(var + 64e-5)
    out = oh.reshape(b, s, d) * p["ln_x"].to(torch.float32)
    out = (out * g.to(torch.float32)).to(g.dtype)
    return linear(p["wo"], out, ctx, f"{name}.wo")


def time_mix(p: dict, x: torch.Tensor, *, n_heads: int, head_dim: int,
             chunk: int = CHUNK, ctx: LinearCtx | None = None,
             name: str = "tm", return_state: bool = False,
             state: RWKVState | None = None):
    """Chunked WKV6 over x (B, S, d) -> (B, S, d).

    With ``return_state`` also returns the final (B, H, dk, dv) wkv state
    (the prefill -> decode handoff).  ``state`` resumes mid-sequence
    (chunked prefill): the wkv state and the token-shift register are
    seeded from it instead of zeros."""
    b, s, d = x.shape
    h, dk = n_heads, head_dim
    if state is None:
        x_shift = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        x_shift = torch.cat([state.x_prev_tm.to(x.dtype)[:, None],
                             x[:, :-1]], dim=1)
    xs = _ddlerp(p, x, x_shift - x)
    r, k, v, g, logw = _project_rkvg(p, xs, ctx, name)
    u = p["u"].to(torch.float32)                               # (h, dk)

    nc = -(-s // chunk)
    sp = nc * chunk

    def heads(a):                                              # (nc,b,C,h,dk)
        a = F.pad(a, (0, 0, 0, sp - s))
        return a.reshape(b, nc, chunk, h, dk).movedim(1, 0).to(torch.float32)

    rs, ks, vs = heads(r), heads(k), heads(v)
    lw = heads(logw)
    # padding rows get logw = 0 => w = 1: state preserved, outputs discarded
    la = torch.cumsum(lw, dim=2)                               # inclusive
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=x.device), diagonal=-1)

    st = (torch.zeros((b, h, dk, dk), dtype=torch.float32, device=x.device)
          if state is None else state.s.to(torch.float32))
    outs = []
    for c in range(nc):
        rc, kc, vc, lac, lwc = rs[c], ks[c], vs[c], la[c], lw[c]  # (b,C,h,dk)
        la_prev = lac - lwc                                    # exclusive
        q_dec = rc * torch.exp(la_prev)                        # <= |r|
        k_inv = kc * torch.exp(-lac)                           # clamp-bounded
        scores = torch.einsum("bchk,bshk->bhcs", q_dec, k_inv) * tri
        out = torch.einsum("bhcs,bshv->bchv", scores, vc)      # intra, s < t
        diag = torch.einsum("bchk,bchk->bch", rc * u[None, None], kc)
        out = out + diag[..., None] * vc                       # u-bonus, s = t
        out = out + torch.einsum("bchk,bhkv->bchv", q_dec, st)  # inter
        la_end = lac[:, -1]                                    # (b,h,dk)
        k_carry = kc * torch.exp(la_end[:, None] - lac)        # <= |k|
        st = (st * torch.exp(la_end)[..., None]
              + torch.einsum("bshk,bshv->bhkv", k_carry, vc))
        outs.append(out)
    out = torch.stack(outs, dim=1).reshape(b, sp, h * dk)[:, :s]
    y = _out_proj(p, out, g, ctx, name)
    if return_state:
        return y, st
    return y


def time_mix_decode(p: dict, x: torch.Tensor, state: RWKVState, *,
                    n_heads: int, head_dim: int,
                    ctx: LinearCtx | None = None, name: str = "tm"):
    """One token: x (B, d) -> (out (B, d), new RWKVState with the wkv state
    and the time-mix shift register advanced; a new object, the caller
    decides where it is written)."""
    b, d = x.shape
    h, dk = n_heads, head_dim
    xs = _ddlerp(p, x, state.x_prev_tm - x)
    r, k, v, g, logw = _project_rkvg(p, xs, ctx, name)
    w = torch.exp(logw.to(torch.float32)).reshape(b, h, dk)
    rh = r.to(torch.float32).reshape(b, h, dk)
    kh = k.to(torch.float32).reshape(b, h, dk)
    vh = v.to(torch.float32).reshape(b, h, dk)
    u = p["u"].to(torch.float32)
    kv = torch.einsum("bhk,bhv->bhkv", kh, vh)
    out = torch.einsum("bhk,bhkv->bhv", rh,
                       state.s + u[None, :, :, None] * kv)
    s_new = state.s * w[..., None] + kv
    out = _out_proj(p, out.reshape(b, 1, h * dk), g.reshape(b, 1, d), ctx,
                    name)
    return out[:, 0], dataclasses.replace(state, s=s_new, x_prev_tm=x)


def channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor | None = None,
                ctx: LinearCtx | None = None,
                name: str = "cm") -> torch.Tensor:
    """RWKV6 channel-mix.  Sequence mode for x (B, S, d), with ``x_prev``
    (B, d) seeding the token-shift register for mid-sequence continuation,
    or one step for x (B, d) with the explicit shift register."""
    if x.ndim == 3:
        if x_prev is None:
            xs = F.pad(x, (0, 0, 1, 0))[:, :-1]
        else:
            xs = torch.cat([x_prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    else:
        xs = x_prev
    xx = xs - x
    xk = x + xx * p["mu_k"]
    xr = x + xx * p["mu_r"]
    k = torch.square(F.relu(linear(p["ck"], xk, ctx, f"{name}.ck")))
    kv = linear(p["cv"], k, ctx, f"{name}.cv")
    return torch.sigmoid(linear(p["cr"], xr, ctx, f"{name}.cr")) * kv
