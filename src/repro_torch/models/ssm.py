"""Mamba2 (state-space duality / SSD) blocks — arXiv:2405.21060
(counterpart of :mod:`repro.models.ssm`).

The SSD recurrence  h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) ,
y_t = C_t . h_t + D x_t  is evaluated with the reference's chunked
matmul form (an intra-chunk attention-like block plus the inter-chunk
state recurrence) in plain PyTorch, a Python loop over chunks.  The
port's ``ssd_scan`` kernel is not called here: the reference's model
calls no kernel either.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import (
    constrain,
    is_dtensor,
    on_shards,
    splittable,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

F32 = L.F32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return L.torch_dtype(cfg.param_dtype)


def init_mamba(gen, cfg: ModelConfig, n_layers: int, device) -> Dict:
    d, di = cfg.d_model, cfg.d_inner
    n, h, k = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    dt = _dtype(cfg)

    def const(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "wx": L.dense_init(gen, (n_layers, d, di), dt, 1, device),
        "wz": L.dense_init(gen, (n_layers, d, di), dt, 1, device),
        "wB": L.dense_init(gen, (n_layers, d, n), dt, 1, device),
        "wC": L.dense_init(gen, (n_layers, d, n), dt, 1, device),
        "wdt": L.dense_init(gen, (n_layers, d, h), dt, 1, device),
        "dt_bias": const((n_layers, h), 0.0),
        "A_log": const((n_layers, h), 0.0, F32),
        "D": const((n_layers, h), 1.0),
        "conv": L.normal_init(gen, (n_layers, di, k), dt, 1.0 / k, device),
        "norm": const((n_layers, di), 1.0),
        "out": L.dense_init(gen, (n_layers, di, d), dt, 1, device),
        "ln": const((n_layers, d), 1.0),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, C); w: (C, K).

    ``out[t] = sum_k x[t - K + 1 + k] * w[:, k]`` as K shifted products
    summed in float32 (``mamba_decode``'s window form), not a library
    convolution: no cuDNN algorithm, no TF32.
    """
    k = w.shape[-1]
    s = x.shape[1]
    xf = x.to(F32)
    # zeros before the sequence by a concatenation, not ``F.pad``: DTensor
    # has no working ``constant_pad_nd`` backward on every release
    xp = torch.cat([xf.new_zeros((xf.shape[0], k - 1, xf.shape[2])), xf],
                   dim=1)
    wf = w.to(x.dtype).to(F32)
    out = xp[:, 0:s] * wf[:, 0]
    for j in range(1, k):
        out = out + xp[:, j:j + s] * wf[:, j]
    return out.to(x.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                initial_state=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (plain PyTorch, the reference's jnp oracle).

    x: (B, S, H, P); dt: (B, S, H); A: (H,) negative; Bm/Cm: (B, S, N).
    Returns (y (B,S,H,P), final_state (B,H,P,N)).  DTensor inputs run
    on each rank's own batch rows and heads (:func:`_ssd_on_shards`).
    """
    if is_dtensor(x):
        return _ssd_on_shards(x, dt, A, Bm, Cm, chunk, initial_state)
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    cl = min(chunk, s)
    if s % cl:
        raise ValueError(f"sequence {s} is not a multiple of chunk {cl}")
    nc = s // cl

    xr = x.reshape(b, nc, cl, h, p).to(F32)
    dtr = dt.reshape(b, nc, cl, h).to(F32)
    Br = Bm.reshape(b, nc, cl, n).to(F32)
    Cr = Cm.reshape(b, nc, cl, n).to(F32)
    dA = dtr * A[None, None, None, :]               # (B,nc,cl,H) log-decay
    cs = torch.cumsum(dA, dim=2)                    # inclusive cumsum
    xdt = xr * dtr[..., None]                       # dt-weighted inputs

    state = (torch.zeros((b, h, p, n), dtype=F32, device=x.device)
             if initial_state is None else initial_state)
    causal = torch.tril(torch.ones((cl, cl), dtype=F32, device=x.device))
    ys = []
    for c in range(nc):
        xc, csc, Bc, Cc = xdt[:, c], cs[:, c], Br[:, c], Cr[:, c]
        # Intra-chunk ("diag block"): M[i,j] = (C_i.B_j) exp(cs_i-cs_j), j<=i
        G = torch.einsum("bin,bjn->bij", Cc, Bc)
        decay = torch.exp(csc[:, :, None, :] - csc[:, None, :, :])
        M = G[:, :, :, None] * decay * causal[None, :, :, None]
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xc)
        # Contribution of the carried state: exp(cs_i) C_i . state
        sdec = torch.exp(csc)
        y_inter = torch.einsum("bin,bhpn,bih->bihp", Cc, state, sdec)
        # Next state: chunk-end decay of current + new outer products
        edec = torch.exp(csc[:, -1:, :] - csc)
        new_state = torch.einsum("bjn,bjhp,bjh->bhpn", Bc, xc, edec)
        state = torch.exp(csc[:, -1, :])[:, :, None, None] * state + new_state
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), state


def _ssd_on_shards(x, dt, A, Bm, Cm, chunk: int, initial_state):
    """:func:`ssd_chunked` of DTensors.  The scan is local to a batch row
    and a head (B and C are shared by a row's heads), so each rank scans
    its own rows and heads: x's layout with its sequence and head width
    whole, dt, A and the state in it, B and C split by rows alone.  A rank
    sees only its heads' share of B's, C's and A's gradients (partial
    over the head axes) and only its rows' share of A's (partial over
    the row axes)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    rows = [p.is_shard(0) for p in x.placements]
    heads = [p.is_shard(2) for p in x.placements]

    def lay(row_dim, head_dim, partial_rows=False, partial_heads=False):
        out = []
        for r, hd in zip(rows, heads):
            if r:
                out.append(Partial() if partial_rows else Shard(row_dim)
                           if row_dim is not None else Replicate())
            elif hd:
                out.append(Partial() if partial_heads else Shard(head_dim)
                           if head_dim is not None else Replicate())
            else:
                out.append(Replicate())
        return out

    px, pdt, pa = lay(0, 2), lay(0, 2), lay(None, 0)
    pbc, pst = lay(0, None), lay(0, 1)
    args = [t.redistribute(mesh, pl) for t, pl in
            ((x, px), (dt, pdt), (A, pa), (Bm, pbc), (Cm, pbc))]
    state_pl = None
    if initial_state is not None:
        initial_state = initial_state.redistribute(mesh, pst)
        state_pl = pst
    grads = (px, pdt, lay(None, 0, partial_rows=True),
             lay(0, None, partial_heads=True),
             lay(0, None, partial_heads=True), None, state_pl)
    return on_shards(ssd_chunked, mesh, (px, pst),
                     (px, pdt, pa, pbc, pbc, None, state_pl), grads)(
        *args, chunk, initial_state)


def mamba_block(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One Mamba2 block (train/prefill).  x: (B, S, d)."""
    b, s, _ = x.shape
    # the in-projections run column-parallel on the whole sequence, so
    # that no product leaves a partial sum to meet the head-sharded conv,
    # bias and D (PyTorch 2.11 would turn those into partial sums, which
    # it cannot)
    h = constrain(L.rms_norm(x, p["ln"], cfg.norm_eps), "dp", None, None)
    xi = L.einsum("bsd,de->bse", h, p["wx"])        # (B,S,di)
    z = L.einsum("bsd,de->bse", h, p["wz"])
    Bm = L.einsum("bsd,dn->bsn", h, p["wB"])
    Cm = L.einsum("bsd,dn->bsn", h, p["wC"])
    dt_raw = constrain(L.einsum("bsd,dh->bsh", h, p["wdt"]),
                       "dp", None, "model")
    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"].to(F32))
    xi = F.silu(causal_conv(xi, p["conv"]))
    hh, pp = cfg.ssm_heads, cfg.ssm_head_dim
    xi = splittable(constrain(xi, "dp", None, "model"), 2, hh)
    A = -torch.exp(p["A_log"])
    xh = L.reshape(xi, b, s, hh, pp)
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = L.reshape(y, b, s, cfg.d_inner)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return x + T.residual(cfg, L.einsum("bse,ed->bsd", y, p["out"]))


def init_ssm_cache(cfg: ModelConfig, batch: int, n_layers: int,
                   dtype=F32, device=None) -> Dict:
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, cfg.ssm_heads,
                              cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=dtype, device=device),
    }


def mamba_decode(p, cfg: ModelConfig, x, conv_state, ssm_state):
    """One-token Mamba2 step.  x: (B, 1, d).  Returns (out, new_conv,
    new_state)."""
    b = x.shape[0]
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)[:, 0]   # (B, d)
    xi = h @ p["wx"]
    z = h @ p["wz"]
    Bm = (h @ p["wB"]).to(F32)                       # (B, N)
    Cm = (h @ p["wC"]).to(F32)
    dt = F.softplus((h @ p["wdt"]).to(F32)
                    + p["dt_bias"].to(F32))          # (B, H)
    # conv ring: conv_state (B, K-1, di) holds the previous inputs.
    window = torch.cat([conv_state, xi[:, None, :].to(conv_state.dtype)],
                       dim=1)
    conv_out = L.einsum("bkc,ck->bc", window, p["conv"].to(F32))
    new_conv = window[:, 1:, :]
    xi = F.silu(conv_out)                            # (B, di)
    hh, pp = cfg.ssm_heads, cfg.ssm_head_dim
    xh = xi.reshape(b, hh, pp).to(F32)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])               # (B, H)
    new_state = (decay[:, :, None, None] * ssm_state
                 + torch.einsum("bhp,bn,bh->bhpn", xh, Bm, dt))
    y = torch.einsum("bn,bhpn->bhp", Cm, new_state)
    y = y + xh * p["D"].to(F32)[None, :, None]
    y = y.reshape(b, cfg.d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["out"])[:, None, :]                 # (B, 1, d)
    return x + out, new_conv, new_state


def forward(params, cfg: ModelConfig, x) -> torch.Tensor:
    """The Mamba stack on embedded inputs; returns the final hidden (the
    reference's SSM loss and logits paths each pin the embedded inputs)."""
    x = constrain(x, "dp", T._seq_axis(cfg), None)
    for lp in L.layers(params["layers"], cfg.n_layers):
        x = T.remat_call(cfg, mamba_block, lp, cfg, x)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(params, cfg: ModelConfig, batch) -> torch.Tensor:
    hidden = forward(params, cfg, T.embed(params, cfg, batch["tokens"]))
    logits = T.logits_fn(params, cfg, hidden)
    return L.softmax_xent(logits, batch["labels"], cfg.vocab_size)


def init_params(gen, cfg: ModelConfig, device) -> Dict:
    d, v = cfg.d_model, cfg.padded_vocab
    dt = _dtype(cfg)
    return {
        "embed": L.embed_init(gen, (v, d), dt, device),
        "layers": init_mamba(gen, cfg, cfg.n_layers, device),
        "final_norm": torch.ones((d,), dtype=dt, device=device),
        "head": L.dense_init(gen, (d, v), dt, 0, device),
    }


def decode_step(params, cfg: ModelConfig, cache, tokens, cur_len,
                inplace: bool = False):
    """One-token step; with ``inplace`` each layer's new conv and state
    rows are copied into ``cache``'s own tensors and ``cache`` is
    returned."""
    x = T.embed(params, cfg, tokens)
    convs, states = [], []
    for i in range(cfg.n_layers):
        x, nc, ns = mamba_decode(L.layer(params["layers"], i), cfg, x,
                                 cache["conv"][i], cache["state"][i])
        if inplace:
            cache["conv"][i].copy_(nc)
            cache["state"][i].copy_(ns)
        convs.append(nc)
        states.append(ns)
    hidden = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = T.logits_fn(params, cfg, hidden)
    if inplace:
        return logits, cache
    return logits, {"conv": torch.stack(convs), "state": torch.stack(states)}
